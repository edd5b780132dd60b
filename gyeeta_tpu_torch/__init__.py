"""PyTorch/CUDA port of ``gyeeta_tpu``: the aggregation tier's main path.

A second package beside the JAX one, with the same module layout and
names, so each counterpart is easy to find: ``runtime.py`` (``Runtime``:
``feed`` → ``run_tick`` → ``query``), ``ingest/{wire,decode}.py``,
``sim/partha.py``, ``sketch/*``, ``engine/*``, ``parallel/*`` (the
dependency graph and the sharded tier: ``ShardedRuntime`` over a mesh of
per-shard states driven from one process),
``semantic/*``, ``query/*`` (readbacks, criteria, aggregation, the
JSON query API, the CRUD channel, continuous queries), ``alerts/*``
(the alert manager and webhook delivery), ``trace/defs.py``,
``obs/*`` and ``utils/*`` (hashing, interning, config, checkpoints,
self-stats, the host-side registries, the notification log, drop
pressure, the journal), ``history/*``, and the serving edge: ``net/*``
(``GytServer``, the query executor, subscriptions, the NM and REST
edges, the query client), ``ingest/native`` (the C++ deframer and
columnar decoder, built with ``g++``), ``ingest/refproto.py`` (stock
partha streams), ``server_main.py`` and ``cli.py`` (``python -m
gyeeta_tpu_torch serve``), and the sharded tier's worker processes: the
multi-process ingest edge over shared-memory rings (``net/ingestproc.py``,
``utils/shmring.py``), the remote ingest relay (``net/relay.py``) and the
parallel compactor into a parted shard store
(``history/compactproc.py``); and the agent tier: ``net/agent.py``
(``NetAgent`` and its supervision), its host collectors
(``net/{collect,tcpconn,taskproc,procconn,taskdelays}.py``), the chaos
proxy and the node-webserver client (``sim/{chaos,nodeweb}.py``), with
the ``agent``, ``replay``, ``obs``, ``nm`` and ``chaos`` commands. The
agent tier imports no ``torch``: an agent host has no GPU.

The two Pallas kernels of the reference
(``gyeeta_tpu/sketch/pallas_scatter.py``) are hand-written CUDA kernels
here (``csrc/sketch_update.cu`` fused on the fold path, the generic
``csrc/scatter.cu`` beside them). Entry points take an explicit
``device``: CUDA by default, and they raise when no GPU is present
unless the caller asks for ``device="cpu"``, where each kernel wrapper
runs its plain PyTorch version.

The package imports ``torch`` and numpy, never ``jax`` and nothing of
``gyeeta_tpu``: what it needs of the reference it keeps as its own copy.
"""
