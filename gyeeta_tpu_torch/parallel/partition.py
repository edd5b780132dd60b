"""Shard layout: where sharded data lives, declared once.

Counterpart of ``gyeeta_tpu/parallel/partition.py``. The reference's
layout is a list of partition rules resolved to XLA shardings of the
stacked ``(n_shards, ...)`` pytrees; in the port every shard's state is
its own tensors on its own device (``parallel/mesh.py``), so the layout
is the mesh plus the host-facing rules every tier shares: the sticky
host→shard hash the ingest edge stages by, the per-shard WAL subdir
names, the placement of per-shard host batches, and the conversion
between the per-shard leaves and the reference's stacked leaves
(checkpoints, history shards and the tests carry stacked leaves).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from gyeeta_tpu_torch.parallel.mesh import Mesh, make_mesh, shard_of_host


def named_tree_paths(tree, sep: str = "/"):
    """Flatten ``tree`` to ``[(path, leaf)]`` with ``sep``-joined path
    names (NamedTuple fields and dict keys become path components —
    e.g. ``state/tbl/key_hi``)."""
    out = []

    def walk(prefix, node):
        if hasattr(node, "_fields"):          # NamedTuple
            for f in node._fields:
                walk(prefix + [f], getattr(node, f))
        elif isinstance(node, dict):
            for k in sorted(node):
                walk(prefix + [str(k)], node[k])
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(prefix + [str(i)], v)
        else:
            out.append((sep.join(prefix), node))

    walk([], tree)
    return out


def stack_leaves(per_shard: list) -> list:
    """Per-shard leaf lists (each in the reference's flattened order)
    → the reference's stacked ``(n_shards, ...)`` leaves."""
    return [np.stack(xs) for xs in zip(*per_shard)]


def unstack_leaves(stacked, n: int) -> list:
    """Inverse of :func:`stack_leaves`: stacked leaves → ``n`` per-shard
    leaf lists. Raises when a leaf's leading axis is not ``n``."""
    stacked = [np.asarray(a) for a in stacked]
    for a in stacked:
        if a.ndim == 0 or a.shape[0] != n:
            raise ValueError(f"stacked leaf of shape {a.shape} does not "
                             f"hold {n} shards")
    return [[a[s] for a in stacked] for s in range(n)]


class ShardLayout:
    """The mesh and the host-facing placement rules: the ingest edge,
    the WAL and replay place by the same stable rule the fold uses, so
    a chunk journaled for host h replays into the shard that folded it
    (stable across reconnect and restore)."""

    WAL_SUBDIR_FMT = "shard_{:02d}"

    def __init__(self, mesh: Optional[Mesh] = None):
        self.mesh = mesh if mesh is not None else make_mesh()
        self.n = self.mesh.n

    def shard_of_host(self, host_id):
        """The ingest-edge hash: host → shard (scalars and arrays)."""
        return shard_of_host(host_id, self.n)

    def wal_subdir(self, shard: int) -> str:
        """Per-shard WAL subdirectory name (``utils/journal.py``'s
        ``ShardedJournal``)."""
        return self.WAL_SUBDIR_FMT.format(int(shard))

    def put(self, batches: list, staged: bool = False) -> list:
        """Per-shard host batches (any batch NamedTuple of
        ``ingest/decode.py``) → the same batches as tensors on each
        shard's device."""
        from gyeeta_tpu_torch.ingest import decode
        return [decode.to_device(b, d, staged=staged)
                for b, d in zip(batches, self.mesh.devices)]
