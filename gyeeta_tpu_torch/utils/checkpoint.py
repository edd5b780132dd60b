"""Checkpoint/restore of engine state, in the reference's npz format.

Counterpart of ``gyeeta_tpu/utils/checkpoint.py``. A checkpoint is an
``npz`` of the state's flattened leaves (``leaf_0`` …, in the
reference's order and dtypes: ``aggstate.state_to_numpy``) plus a
``__meta__`` JSON blob with ``nleaves``, the config fingerprint
``sha256(repr(cfg))[:16]`` and ``extra``. The port's ``EngineCfg`` has
the reference's ``repr``, so a checkpoint written by either package
restores in the other. The sharded runtime's per-shard states (a list)
save as the reference's mesh checkpoint: each leaf stacked over the
shards, ``(n_shards, ...)``. Saves are atomic and durable: tmp → fsync
→ rename → fsync of the directory; each save sweeps stale tmp files.
"""

from __future__ import annotations

import hashlib
import json
import os
import pathlib

import numpy as np
import torch

from gyeeta_tpu_torch.engine import aggstate
from gyeeta_tpu_torch.parallel.partition import stack_leaves, \
    unstack_leaves
from gyeeta_tpu_torch.utils.tensor import tree_leaves


def _cfg_fingerprint(cfg) -> str:
    return hashlib.sha256(repr(cfg).encode()).hexdigest()[:16]


def save(path, cfg, state, extra: dict | None = None) -> pathlib.Path:
    """Write the state (one ``AggState``, or a list of per-shard ones)
    → ``path`` (npz), atomically and durably."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    if isinstance(state, list):
        leaves = stack_leaves([aggstate.state_to_numpy(st)
                               for st in state])
    else:
        leaves = aggstate.state_to_numpy(state)
    payload = {f"leaf_{i}": x for i, x in enumerate(leaves)}
    payload["__meta__"] = np.frombuffer(json.dumps({
        "nleaves": len(leaves),
        "cfg": _cfg_fingerprint(cfg),
        "extra": extra or {},
    }).encode(), dtype=np.uint8)
    tmp = path.with_suffix(".tmp.npz")
    with open(tmp, "wb") as f:
        np.savez_compressed(f, **payload)
        f.flush()
        os.fsync(f.fileno())      # file contents durable before rename
    tmp.rename(path)
    try:                          # …and the rename itself durable
        dfd = os.open(path.parent, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except OSError:               # pragma: no cover — exotic fs
        pass
    sweep_stale_tmp(path.parent)
    return path


def sweep_stale_tmp(ckpt_dir) -> int:
    """Delete ``*.tmp.npz`` orphans of a crash mid-:func:`save`; never
    touches completed checkpoints. Returns files removed."""
    n = 0
    d = pathlib.Path(ckpt_dir)
    if not d.is_dir():
        return 0
    for p in d.glob("*.tmp.npz"):
        try:
            os.unlink(p)
            n += 1
        except OSError:           # pragma: no cover — already gone
            pass
    return n


def restore(path, cfg, like, device=None):
    """Read a checkpoint with the leaf structure of ``like`` onto
    ``device`` (``like``'s by default) → ``(state, extra)``. ``like`` a
    list of per-shard states reads a stacked mesh checkpoint of that
    many shards back onto each shard's device. Raises ValueError on a
    config-fingerprint, leaf-count or shape mismatch."""
    path = pathlib.Path(path)
    shards = like if isinstance(like, list) else None
    like_leaves = tree_leaves(like[0] if shards is not None else like)
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        if meta["cfg"] != _cfg_fingerprint(cfg):
            raise ValueError(
                f"checkpoint config fingerprint {meta['cfg']} does not "
                f"match engine config {_cfg_fingerprint(cfg)}")
        if meta["nleaves"] != len(like_leaves):
            raise ValueError(
                f"checkpoint has {meta['nleaves']} leaves, engine state "
                f"has {len(like_leaves)} — incompatible versions")
        leaves = fit_leaves([z[f"leaf_{i}"] for i in range(len(like_leaves))],
                            like)
    if shards is not None:
        return [aggstate.state_from_numpy(
                    per, tree_leaves(st)[0].device if device is None
                    else device)
                for per, st in zip(unstack_leaves(leaves, len(shards)),
                                   shards)], meta["extra"]
    dev = like_leaves[0].device if device is None else device
    return aggstate.state_from_numpy(leaves, dev), meta["extra"]


def fit_leaves(leaves, like, what: str = "checkpoint") -> list:
    """Numpy ``leaves`` checked against the live tree ``like`` (a state
    or dep; a list of per-shard ones takes the stacked ``(n_shards,
    ...)`` leaves) and cast to its leaves' reference dtypes. Raises
    ValueError on a leaf-count or shape mismatch."""
    shards = like if isinstance(like, list) else None
    refs = tree_leaves(like[0] if shards is not None else like)
    lead = (len(shards),) if shards is not None else ()
    if len(leaves) != len(refs):
        raise ValueError(f"{what} has {len(leaves)} leaves, engine state "
                         f"has {len(refs)} — incompatible versions")
    out = []
    for i, (arr, ref) in enumerate(zip(leaves, refs)):
        if arr.shape != lead + tuple(ref.shape):
            raise ValueError(
                f"leaf {i}: {what} shape {arr.shape} != "
                f"state shape {lead + tuple(ref.shape)}")
        out.append(arr.astype(_ref_dtype(ref), copy=False))
    return out


def _ref_dtype(t) -> np.dtype:
    """The reference's numpy dtype of a state leaf (int64 = u32
    carrier)."""
    if t.dtype == torch.int64:
        return np.dtype(np.uint32)
    return torch.empty(0, dtype=t.dtype).numpy().dtype
