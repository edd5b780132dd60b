"""The dependency graph and the sharded tier.

Counterpart of ``gyeeta_tpu/parallel/``. The reference maps madhava's
and shyama's roles onto a device mesh driven by one controller; the
port drives a mesh of per-shard states from one process:

- hosts are data-parallel: each shard owns the full engine state for
  its slice of the host-id space (``mesh.py``, ``sharded.py``),
- the shyama roll-up is ``psum``/``pmax``/gather of the shards' sketch
  tensors (``rollup.py``),
- cross-shard conn pairing is a capacity-bucketed ``all_to_all`` of
  conn halves to their flow-key owner shard plus a pair table
  (``pairing.py``, ``depgraph.py``),
- :class:`ShardedRuntime` (``shardedrt.py``) is the product loop over
  it, imported lazily (it pulls in the query and alert tiers).
"""


def __getattr__(name):
    if name == "ShardedRuntime":
        from gyeeta_tpu_torch.parallel.shardedrt import ShardedRuntime
        return ShardedRuntime
    raise AttributeError(name)
