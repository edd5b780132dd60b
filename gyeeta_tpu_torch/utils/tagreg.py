"""User tag registry: process-group id → tag text.

The reference keeps a per-aggr-task tag buffer set from the web tier
(``server/gy_msocket.h:960`` MAGGR_TASK tagbuf_, surfaced as
``procinfo.tag``, FIELD_TAG ``gy_json_field_maps.h:1814``; its
SUBSYS_TAGS enum has no field map of its own). Here: a bounded
host-side registry, CRUD objtype "tag", joined into procinfo rows at
query time (OUTSIDE the snapshot cache — tags mutate without a state
version bump) and listable as the ``tags`` subsystem.

A copy of ``gyeeta_tpu/utils/tagreg.py`` (no JAX): the port imports nothing of
the JAX package.
"""

from __future__ import annotations

import numpy as np

MAX_TAG_LEN = 128                  # ref MAX_TOTAL_TAG_LEN discipline
MAX_TAGS = 65536


class TagRegistry:
    def __init__(self):
        self._tags: dict[str, str] = {}     # taskid hex → tag

    def set(self, taskid: str, tag: str) -> None:
        taskid = taskid.lower()
        if len(taskid) != 16 or not all(
                c in "0123456789abcdef" for c in taskid):
            raise ValueError("taskid must be a 16-hex-digit id")
        if not tag:
            raise ValueError("tag must be non-empty (delete to clear)")
        if len(self._tags) >= MAX_TAGS and taskid not in self._tags:
            raise ValueError(f"tag registry full ({MAX_TAGS})")
        self._tags[taskid] = str(tag)[:MAX_TAG_LEN]

    def delete(self, taskid: str) -> bool:
        return self._tags.pop(taskid.lower(), None) is not None

    def __len__(self) -> int:
        return len(self._tags)

    def of(self, taskids: np.ndarray) -> np.ndarray:
        """(N,) object array of tags ('' untagged) for hex taskids."""
        return np.array([self._tags.get(t, "") for t in taskids],
                        object)

    def with_tags(self, colmask):
        """procinfo (cols, mask) → same with the tag column joined."""
        cols, mask = colmask
        out = dict(cols)
        out["tag"] = self.of(cols["taskid"])
        return out, mask

    def columns(self):
        """(cols, mask) for the ``tags`` subsystem listing."""
        items = sorted(self._tags.items())
        return ({"taskid": np.array([k for k, _ in items], object),
                 "tag": np.array([v for _, v in items], object)},
                np.ones(len(items), bool))
