"""Multi-resolution time windows over additive sketch state.

Counterpart of ``gyeeta_tpu/sketch/windows.py``: a base slab ``cur``
filled every 5 s tick, one ring of sub-slabs plus a rolling total per
level, and a lifetime accumulator. :func:`tick` updates every buffer in
place (the reference donates them) and evaluates both sides of each
tick predicate, as the reference's branch-free ``jnp.where`` does, so
it never reads the tick count back to the host.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from gyeeta_tpu_torch.device import resolve


class WindowSpec(NamedTuple):
    """One level: covers ``stride_ticks * nslots`` base ticks."""
    stride_ticks: int  # base ticks per sub-slab
    nslots: int        # ring length

    @property
    def span_ticks(self) -> int:
        return self.stride_ticks * self.nslots


# 5s base tick: 5 min = 60 ticks at 25 s resolution; 5 days = 86400
# ticks at 5 h resolution.
LEVELS_DEFAULT: tuple[WindowSpec, ...] = (
    WindowSpec(stride_ticks=5, nslots=12),     # 5 min span, 25 s resolution
    WindowSpec(stride_ticks=3600, nslots=24),  # 5 day span, 5 h resolution
)


class MultiWindow(NamedTuple):
    """cur (shape), rings (nslots, *shape) per level, totals (shape) per
    level, alltime (shape), tick () int32."""
    cur: torch.Tensor
    rings: tuple
    totals: tuple
    alltime: torch.Tensor
    tick: torch.Tensor


def init(shape: tuple, levels: Sequence[WindowSpec] = LEVELS_DEFAULT,
         dtype=torch.float32, device=None) -> MultiWindow:
    dev = resolve(device)
    z = lambda s: torch.zeros(s, dtype=dtype, device=dev)  # noqa: E731
    return MultiWindow(
        cur=z(tuple(shape)),
        rings=tuple(z((lv.nslots,) + tuple(shape)) for lv in levels),
        totals=tuple(z(tuple(shape)) for _ in levels),
        alltime=z(tuple(shape)),
        tick=torch.zeros((), dtype=torch.int32, device=dev),
    )


def add(win: MultiWindow, delta) -> MultiWindow:
    """Accumulate into the current base slab, in place (called per
    microbatch)."""
    win.cur.add_(delta)
    return win


def tick(win: MultiWindow, levels: Sequence[WindowSpec] = LEVELS_DEFAULT
         ) -> MultiWindow:
    """Close the current base slab: fold into every level, advance rings
    (in place)."""
    t = win.tick
    for lv, ring, total in zip(levels, win.rings, win.totals):
        slot = ((t // lv.stride_ticks) % lv.nslots).to(torch.int64)
        boundary = (t % lv.stride_ticks) == 0
        # at a stride boundary the slab at `slot` expires and is replaced
        old = ring.index_select(0, slot.reshape(1))[0]
        ring.index_copy_(0, slot.reshape(1),
                         torch.where(boundary, win.cur, old + win.cur)[None])
        # resync the rolling total from the ring at each boundary (f32
        # add/subtract drift); off-boundary: cheap increment
        total.copy_(torch.where(boundary, ring.sum(dim=0), total + win.cur))
    win.alltime.add_(win.cur)
    win.cur.zero_()
    win.tick.add_(1)
    return win


def read(win: MultiWindow, level: int):
    """Windowed sum for a level: -1 = current base slab, len(levels) = all."""
    if level == -1:
        return win.cur
    if level < len(win.totals):
        return win.totals[level] + win.cur
    return win.alltime + win.cur
