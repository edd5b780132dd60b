"""Tensor helpers that keep the port's results equal to the reference's.

- :func:`top_k` — ``lax.top_k`` order: descending, the LOWER index first
  on ties. ``torch.topk`` promises no tie order, and ties are the normal
  case here (padding and cold lanes all score −1, stage fills repeat),
  so every top-k of the port goes through one stable descending sort.
- :func:`set_drop` / :func:`add_drop` / :func:`set_rows_drop` /
  :func:`reduce_drop` — JAX's ``mode="drop"`` scatters: lanes whose
  ``keep`` is False write nothing. PyTorch raises on an out-of-range
  index, so dropped lanes are pointed at element 0 and made harmless
  there, without a device→host sync.
- :func:`compact_true` — ``jnp.nonzero(mask, size=D, fill_value=F)``
  without the sync of ``torch.nonzero``.
- :func:`tree_leaves` / :func:`tree_unflatten` — flatten a NamedTuple /
  tuple tree of tensors in ``jax.tree_util.tree_flatten`` order.
"""

from __future__ import annotations

import torch

from gyeeta_tpu_torch.sketch import scatter


def top_k(x: torch.Tensor, k: int):
    """(values, indices) of the ``k`` largest entries along the last
    axis, descending, lower index first on ties (``lax.top_k``'s
    order)."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def set_drop(dst: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor,
             keep: torch.Tensor) -> None:
    """In place: ``dst.view(-1)[idx[i]] = vals[i]`` where ``keep[i]``.

    Kept lanes that share an index must carry equal values (the callers'
    invariant, as in the reference: the write is well defined only
    then). Dropped lanes are aimed at element 0, which is restored
    afterwards unless a kept lane wrote it."""
    flat = dst.view(-1)
    vals = vals.to(flat.dtype)
    tgt = torch.where(keep, idx.to(torch.int64), 0)
    old0 = flat[0].clone()
    flat.index_put_((tgt,), vals)
    kept0 = keep & (tgt == 0)
    lowest = (torch.finfo(flat.dtype).min if flat.dtype.is_floating_point
              else torch.iinfo(flat.dtype).min)
    v0 = torch.where(kept0, vals, torch.full_like(vals, lowest)).max() \
        if vals.numel() else old0
    flat[0] = torch.where(kept0.any(), v0, old0)


def add_drop(dst: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor,
             keep: torch.Tensor) -> None:
    """In place: ``dst[idx[i]] += vals[i]`` (along dim 0) where ``keep[i]``,
    in lane order on the CPU.

    A 1-D int32 ``dst`` on CUDA with 1-D values (the t-digest stage
    counts) launches the int32 scatter-add of ``csrc/scatter.cu``
    (``scatter.scatter_add`` with ``keep``, counted as the ``add_drop``
    route): dropped lanes write nothing, and an integer sum is exact in
    any order, so the result is the one the sorted
    ``index_put_(accumulate=True)`` gives. Everything else —
    float targets, 2-D values, the CPU — stays on ``index_put_``: its
    dropped lanes add zero to row 0, which leaves it unchanged (the
    callers' sums never hold −0.0). Floats stay there because atomic
    float sums in another order would move the card-vs-CPU leaf
    comparisons of the float counters off bit equality."""
    if dst.device.type == "cuda" and dst.dtype == torch.int32 \
            and dst.dim() == 1 and vals.dim() == 1:
        scatter.scatter_add(dst, idx.contiguous(),
                            vals.to(torch.int32).contiguous(),
                            keep=keep.contiguous(), route="add_drop")
        return
    tgt = torch.where(keep, idx.to(torch.int64), 0)
    shape = (-1,) + (1,) * (vals.dim() - 1)
    v = torch.where(keep.view(shape), vals.to(dst.dtype),
                    torch.zeros((), dtype=dst.dtype, device=dst.device))
    dst.index_put_((tgt,), v, accumulate=True)


def set_rows_drop(dst: torch.Tensor, idx: torch.Tensor, vals,
                  keep: torch.Tensor) -> None:
    """In place: ``dst[idx[i]] = vals[i]`` (whole rows along dim 0) where
    ``keep[i]``, for any dtype (bool included). ``vals`` broadcasts to
    ``(B,) + dst.shape[1:]``, so a scalar sets every kept row to it.

    Kept lanes sharing a row should carry equal values (the callers'
    invariant); where they do not, the CPU keeps the last lane's, as
    JAX's CPU scatter does. Row 0, where dropped lanes are aimed, is
    rebuilt from the last kept lane that targets it, else its old
    value."""
    n = idx.shape[0]
    if n == 0:
        return
    shape = (n,) + tuple(dst.shape[1:])
    # a Python scalar is filled on the device: a copy from the host
    # would be a blocking transfer, i.e. a sync
    vals = vals.to(dst.dtype).expand(shape) \
        if isinstance(vals, torch.Tensor) \
        else torch.full(shape, vals, dtype=dst.dtype, device=dst.device)
    tgt = torch.where(keep, idx.to(torch.int64), 0)
    kept0 = keep & (tgt == 0)
    last = n - 1 - torch.argmax(kept0.flip(0).to(torch.uint8), 0, True)
    # a (1,) index tensor: indexing with a 0-d one would read it back
    row0 = torch.where(kept0.any(), vals[last][0], dst[0])
    dst.index_put_((tgt,), vals)
    dst[0] = row0


def reduce_drop(dst: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor,
                keep: torch.Tensor, reduce: str) -> None:
    """In place: ``dst[idx[i]] = max / min(dst[idx[i]], vals[i])`` along
    dim 0 where ``keep[i]`` (``reduce`` is ``"amax"`` or ``"amin"``, the
    ``.at[].max`` / ``.at[].min`` of JAX). Dropped lanes reduce the
    identity (the dtype's lowest / highest value) into row 0."""
    vals = vals.to(dst.dtype)
    if dst.dtype.is_floating_point:
        fill = -torch.inf if reduce == "amax" else torch.inf
    else:
        info = torch.iinfo(dst.dtype)
        fill = info.min if reduce == "amax" else info.max
    tgt = torch.where(keep, idx.to(torch.int64), 0)
    shape = (-1,) + (1,) * (vals.dim() - 1)
    v = torch.where(keep.view(shape), vals,
                    torch.full((), fill, dtype=dst.dtype, device=dst.device))
    dst.index_reduce_(0, tgt, v, reduce)


def compact_true(mask: torch.Tensor, size: int, fill: int) -> torch.Tensor:
    """Ascending indices of ``mask``'s True entries in a fixed ``(size,)``
    int64 tensor, ``fill`` past the last (entries past ``size`` are
    dropped): ``jnp.nonzero(mask, size=size, fill_value=fill)[0]``,
    by a cumulative sum and a scatter, with no device→host sync."""
    pos = torch.cumsum(mask.to(torch.int64), 0) - 1
    slot = torch.where(mask & (pos < size), pos, size)
    out = torch.full((size + 1,), fill, dtype=torch.int64, device=mask.device)
    out.scatter_(0, slot, torch.arange(mask.shape[0], dtype=torch.int64,
                                       device=mask.device))
    return out[:size]


def _is_node(x) -> bool:
    return isinstance(x, tuple)


def tree_leaves(tree) -> list:
    """Leaves of a NamedTuple/tuple tree, depth first, in field order."""
    if _is_node(tree):
        return [leaf for sub in tree for leaf in tree_leaves(sub)]
    return [tree]


def tree_paths(tree, prefix: str = "") -> list:
    """Dotted names of :func:`tree_leaves`' leaves (``resp_win.rings.0``)."""
    if not _is_node(tree):
        return [prefix]
    names = tree._fields if hasattr(tree, "_fields") \
        else [str(i) for i in range(len(tree))]
    return [p for name, sub in zip(names, tree)
            for p in tree_paths(sub, f"{prefix}.{name}" if prefix else name)]


def tree_unflatten(template, leaves):
    """Rebuild ``template``'s structure from ``leaves`` (an iterator or
    list, consumed in :func:`tree_leaves` order)."""
    it = iter(leaves)

    def build(node):
        if _is_node(node):
            kids = [build(sub) for sub in node]
            return type(node)(*kids) if hasattr(node, "_fields") \
                else type(node)(kids)
        return next(it)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


def tree_map(fn, tree):
    return tree_unflatten(tree, [fn(x) for x in tree_leaves(tree)])
