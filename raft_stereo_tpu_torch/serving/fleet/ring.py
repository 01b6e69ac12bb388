"""Consistent-hash ring: session ids -> replicas, with minimal remap.

Streaming sessions (serving/sessions.py) are sticky per-replica state —
a session's warm-start chain lives in exactly one engine's SessionStore,
so the router must send every frame of one session to the same replica.
A modulo hash would do that too, but replica loss under mod-N remaps
(N-1)/N of ALL sessions (every surviving stream breaks because an
unrelated replica died).  Consistent hashing (Karger et al., STOC '97)
bounds the blast radius: each member owns ``vnodes`` pseudo-random
points on a 2^64 ring, a key maps to the first member point at or after
its own hash, and removing a member only reassigns the keys that hashed
to ITS points — ~1/N of the keyspace, the sessions that were already
lost with the replica.  Re-adding the member restores its points (they
are a pure function of the member name), so the original assignment
comes back exactly.

SHA-256 everywhere for the same reason as serving/chaos.py: the mapping
must be identical across processes, platforms, and PYTHONHASHSEED — a
router restart must not reshuffle live sessions, and two routers in
front of one fleet must agree.

Pure data structure, no I/O, no threads (the router serializes access);
tests/test_fleet.py pins the invariants.
"""

from __future__ import annotations

import bisect
import hashlib
from typing import Dict, List, Optional, Sequence, Tuple

# Points per member.  At 64 vnodes the max/mean keyspace-share ratio
# across members stays within ~2x for small fleets — good enough for a
# load split the stateless path doesn't even use (it balances by
# measured queue depth; the ring only pins SESSIONS).
DEFAULT_VNODES = 64


def _point(name: str, vnode: int) -> int:
    digest = hashlib.sha256(f"{name}#{vnode}".encode()).digest()
    return int.from_bytes(digest[:8], "big")


def _key_point(key: str) -> int:
    digest = hashlib.sha256(f"key:{key}".encode()).digest()
    return int.from_bytes(digest[:8], "big")


class HashRing:
    """Members (replica names) on a 2^64 consistent-hash ring.

    ``lookup`` maps a key to a live member; ``remove``/``add`` change
    membership with the ~1/N remap guarantee.  An empty ring looks up to
    None.  Member points are deterministic in the member NAME alone, so
    add(remove(x)) restores the exact prior assignment.
    """

    def __init__(self, members: Sequence[str] = (),
                 vnodes: int = DEFAULT_VNODES):
        if vnodes < 1:
            raise ValueError(f"vnodes={vnodes} must be >= 1")
        self.vnodes = vnodes
        self._members: Dict[str, Tuple[int, ...]] = {}
        self._points: List[int] = []      # sorted ring points
        self._owner: List[str] = []       # _owner[i] owns _points[i]
        for m in members:
            self.add(m)

    # ------------------------------------------------------------ membership
    @property
    def members(self) -> Tuple[str, ...]:
        return tuple(sorted(self._members))

    def __contains__(self, name: str) -> bool:
        return name in self._members

    def __len__(self) -> int:
        return len(self._members)

    def _rebuild(self) -> None:
        pairs = sorted((p, name) for name, pts in self._members.items()
                       for p in pts)
        self._points = [p for p, _ in pairs]
        self._owner = [name for _, name in pairs]

    def add(self, name: str) -> None:
        """Add a member (idempotent).  Only keys falling into the new
        member's arcs move — everything else keeps its owner."""
        if name in self._members:
            return
        self._members[name] = tuple(_point(name, v)
                                    for v in range(self.vnodes))
        self._rebuild()

    def remove(self, name: str) -> None:
        """Remove a member (idempotent).  Keys it owned fall through to
        the next point on the ring; other keys are untouched — the
        ~1/N-remap property tests/test_fleet.py pins."""
        if self._members.pop(name, None) is not None:
            self._rebuild()

    # ---------------------------------------------------------------- lookup
    def lookup(self, key: str) -> Optional[str]:
        """The member owning ``key``, or None on an empty ring."""
        if not self._points:
            return None
        i = bisect.bisect_right(self._points, _key_point(key))
        if i == len(self._points):      # wrap past the top of the ring
            i = 0
        return self._owner[i]

    def assignment(self, keys: Sequence[str]) -> Dict[str, Optional[str]]:
        """Bulk ``{key: member}`` snapshot (test/report helper)."""
        return {k: self.lookup(k) for k in keys}
