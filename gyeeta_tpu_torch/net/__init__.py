"""The serving edge of the port: ``GytServer`` (``server.py``), the query
executor (``qexec.py``), subscriptions (``subs.py``), the stock node-
webserver edge (``nmhandle.py``), the REST gateway (``webgw.py``), the
fan-in fabric gateway (``gateway.py``), the segment-ship receiver of the
remote compaction region (``segship.py``), the per-shard ingest queues
of the sharded runtime (``shardfeed.py``), the multi-process ingest edge
(``ingestproc.py``: worker processes publishing decoded records into
shared-memory rings), the remote ingest relay and its hub (``relay.py``),
and the agent tier: ``agent.py`` (``NetAgent``, registration and the
query client) with its host collectors (``collect.py``, ``tcpconn.py``,
``taskproc.py``, ``procconn.py``, ``taskdelays.py``). Counterpart of
``gyeeta_tpu/net``."""
