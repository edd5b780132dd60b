"""What the port does not have yet, by its ROADMAP.md item.

Every path into a tier that is not ported raises :class:`NotPortedError`
naming the item of ROADMAP.md's queue 1 that ports it: no record is
dropped, no section skipped, no empty answer served in its place.
"""

from __future__ import annotations

# ROADMAP.md, queue 1: the item that ports what is still missing — the
# sharded tier's worker processes (the single-process sharded runtime
# of item 6 is ported)
SHARDED_PROCS = "item 7, the sharded tier's worker processes"


class NotPortedError(NotImplementedError, ValueError):
    """A request, record kind, option or subsystem of an unported tier
    (a ``ValueError`` too, as the reference's refusals of a request
    are)."""


def refuse(what: str, item: str) -> NotPortedError:
    return NotPortedError(f"{what} is not ported yet; see ROADMAP.md, "
                          f"queue 1, {item}")
