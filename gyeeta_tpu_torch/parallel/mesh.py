"""The shard mesh and its collectives, driven from one process.

Counterpart of ``gyeeta_tpu/parallel/mesh.py``. The reference is single
controller: one Python process drives the whole mesh through
``shard_map``, and its collectives (``psum``, ``pmax``, ``all_gather``,
``all_to_all``) are named-axis ops inside one program. The port keeps
that shape without ``torch.distributed``: a :class:`Mesh` is an ordered
list of devices with axis names and sizes, per-shard state lives in a
Python list (shard ``s`` on ``mesh.devices[s]``), and each collective
is an explicit tensor op across the shards' tensors — a reduction runs
in shard order on the first shard's device, a gather concatenates in
shard order, an ``all_to_all`` moves each shard's chunks to their
destination shards' devices. On one card the data does not move: N
shards are N logical shards of ``cuda:0``.

Placement: shard ``s`` goes to card ``s % torch.cuda.device_count()``,
so a node with at least N cards holds one shard a card (the reference's
one device a shard); with fewer cards, shards share them (the reference
raises instead; :func:`make_mesh` logs the sharing). Hosts map to
shards by a stable modulus of their id (:func:`shard_of_host`).
"""

from __future__ import annotations

import logging
from typing import Optional

import torch

from gyeeta_tpu_torch.device import resolve

log = logging.getLogger("gyeeta_tpu_torch.parallel.mesh")

HOST_AXIS = "hosts"
SLICE_AXIS = "slices"    # outer axis of a two-level mesh


class Mesh:
    """Devices of the shards in row-major shard order, with the axis
    names (outermost first) and their sizes. ``shape`` maps each axis
    name to its size, as the reference's ``Mesh.shape`` does."""

    def __init__(self, devices, axis_names: tuple, sizes: tuple):
        self.devices = [torch.device(d) for d in devices]
        self.axis_names = tuple(axis_names)
        self.sizes = tuple(int(s) for s in sizes)
        n = 1
        for s in self.sizes:
            n *= s
        if n != len(self.devices):
            raise ValueError(f"mesh of shape {self.sizes} needs {n} "
                             f"devices, got {len(self.devices)}")
        self.shape = dict(zip(self.axis_names, self.sizes))

    @property
    def n(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, devices="
                f"{[str(d) for d in self.devices]})")


def _shard_devices(n: int, device) -> list:
    """``n`` shard devices on ``device``'s type: CUDA shards round-robin
    over the visible cards (or all on one card when an index is
    given), CPU shards all on the CPU."""
    dev = resolve(device)
    if dev.type != "cuda" or dev.index is not None:
        return [dev] * n
    count = torch.cuda.device_count()
    devs = [torch.device("cuda", s % count) for s in range(n)]
    if count < n:
        log.info("mesh: %d shards share %d card(s) (shard s on card "
                 "s %% %d)", n, count, count)
    return devs


def make_mesh(n_devices: Optional[int] = None, device=None) -> Mesh:
    """1-D mesh of ``n_devices`` shards (default: one a visible card,
    or one on the CPU) on ``device`` — CUDA unless the caller asks for
    the CPU."""
    dev = resolve(device)
    if n_devices is None:
        n_devices = torch.cuda.device_count() if dev.type == "cuda" else 1
    return Mesh(_shard_devices(int(n_devices), dev), (HOST_AXIS,),
                (int(n_devices),))


def make_mesh2d(n_slices: int, per_slice: int, device=None) -> Mesh:
    """Two-level mesh (slices × hosts): collectives reduce over both
    axes, and the pairing dispatch routes in two stages, outer axis
    first, so each flow crosses the outer axis at most once."""
    n = int(n_slices) * int(per_slice)
    return Mesh(_shard_devices(n, device), (SLICE_AXIS, HOST_AXIS),
                (int(n_slices), int(per_slice)))


def axes_of(mesh: Mesh) -> tuple:
    """The mesh's shard axes, outermost first."""
    return tuple(mesh.axis_names)


def shard_of_host(host_id, n_shards: int):
    """Stable host→shard placement (ints, numpy arrays or tensors)."""
    return host_id % n_shards


# ------------------------------------------------------------ collectives
def psum(xs: list):
    """Sum of the shards' tensors, added in shard order on the first
    shard's device."""
    d0 = xs[0].device
    out = xs[0]
    for x in xs[1:]:
        out = out + x.to(d0)
    return out


def pmax(xs: list):
    """Elementwise max of the shards' tensors on the first shard's
    device."""
    d0 = xs[0].device
    out = xs[0]
    for x in xs[1:]:
        out = torch.maximum(out, x.to(d0))
    return out


def gather_all(xs: list):
    """The shards' tensors concatenated along axis 0 in shard order on
    the first shard's device: the reference's tiled ``all_gather`` over
    every mesh axis, innermost first, which lays shards out row-major —
    the mesh's device order."""
    d0 = xs[0].device
    return torch.cat([x.to(d0) for x in xs], dim=0)


def _coords(mesh: Mesh, s: int) -> list:
    out = []
    for size in reversed(mesh.sizes):
        out.append(s % size)
        s //= size
    return out[::-1]


def _index(mesh: Mesh, coords) -> int:
    s = 0
    for c, size in zip(coords, mesh.sizes):
        s = s * size + c
    return s


def all_to_all(xs: list, mesh: Mesh, axis: str) -> list:
    """``lax.all_to_all(split_axis=0, concat_axis=0)`` along one named
    axis: each shard's ``(m·cap, ...)`` tensor splits into ``m`` chunks
    (``m`` the axis size); chunk ``k`` of the shard at axis position
    ``j`` lands as chunk ``j`` of the shard at axis position ``k`` with
    the same other coordinates."""
    ax = mesh.axis_names.index(axis)
    m = mesh.sizes[ax]
    out = []
    for s in range(mesh.n):
        me = _coords(mesh, s)
        pieces = []
        for k in range(m):
            src = list(me)
            src[ax] = k
            x = xs[_index(mesh, src)]
            cap = x.shape[0] // m
            pieces.append(x[me[ax] * cap:(me[ax] + 1) * cap]
                          .to(mesh.devices[s]))
        out.append(torch.cat(pieces, dim=0))
    return out
