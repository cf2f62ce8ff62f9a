"""The shared lazy-expiration index (paper §3.2): one min-expiry heap both
verification planes pop from.

SkyStore's TTL policy is event-driven -- replicas expire lazily off a heap
ordered by ``(expire, object, region)`` -- but before this module the live
metadata server rediscovered expirations by scanning every object, and the
simulator kept a private heap with its own invalidation rules.  Divergence
between the planes was prevented only by carefully mirroring the two code
paths.  :class:`ExpiryIndex` extracts the heap (generation-token
invalidation included) so the :class:`~repro_torch.core.simulator.Simulator`, the
:class:`~repro.core.metadata.MetadataServer`, and the replay event spine
(:mod:`repro_torch.core.engine`) all pop expirations in the *same* order by
construction.

Design notes:

* Entries are ``(expire, order, seq, gen, ident)``.  ``ident`` is the
  caller's identity key (sim: ``(oid, region)``; metadata:
  ``(bucket, key, version, region)``); ``order`` is the cross-plane sort key
  ``(oid, region)`` so both planes tie-break identically; ``seq`` is a
  monotonic insertion counter that fully orders exact ties without ever
  comparing idents.
* Invalidation is *lazy*: :meth:`arm` never removes the superseded heap
  entry, it bumps the ident's generation token so the stale entry is skipped
  (and counted in ``n_stale``) when it surfaces.  Generations are monotonic
  per ident for the index's whole lifetime -- they are never recycled, so a
  disarm+re-arm can never resurrect an old entry.
* Infinite (or pinned -- callers arm those as ``inf``) expiries are recorded
  as "not scheduled": they hold no heap entry and never pop.

Paper anchors: §3.2 ("expiration of an object's replica is performed lazily")
is the semantics implemented here; §5's differential claim is why there is
exactly *one* implementation -- the golden replay matrix
(:mod:`repro.core.replay`, which has a worked both-planes example in its
module docstring) would show any pop-order disagreement as placement
divergence.
"""

from __future__ import annotations

import heapq
import math
from typing import Dict, Hashable, Iterator, List, Optional, Tuple

__all__ = ["ExpiryIndex", "KeyInterner"]


class ExpiryIndex:
    """Min-expiry heap with generation-token invalidation.

    ``arm(ident, order, expire)`` schedules (or reschedules) one replica's
    expiration; ``pop_due(now)`` yields every armed ``(expire, ident)`` with
    ``expire <= now`` in ``(expire, order)`` order.  Popped entries are
    consumed: the caller decides whether to drop the replica or re-arm it
    (the FP sole-copy guard), and a re-arm still below ``now`` is popped
    again within the same drain -- the lazy-heap equivalent of the old
    "re-arm until the expiry clears ``now``" loop.
    """

    __slots__ = ("_heap", "_gen", "_armed", "_seq", "n_pops", "n_stale")

    def __init__(self) -> None:
        self._heap: List[Tuple[float, Tuple, int, int, Hashable]] = []
        self._gen: Dict[Hashable, int] = {}     # ident -> current generation
        self._armed: Dict[Hashable, float] = {}  # ident -> scheduled expire
        self._seq = 0
        #: Valid entries consumed by :meth:`pop_due` (O(expired) work).
        self.n_pops = 0
        #: Superseded entries skipped via generation tokens.
        self.n_stale = 0

    def __len__(self) -> int:
        """Number of currently armed (finite-expiry) idents."""
        return len(self._armed)

    def _bump(self, ident: Hashable) -> int:
        gen = self._gen.get(ident, 0) + 1
        self._gen[ident] = gen
        return gen

    def arm(self, ident: Hashable, order: Tuple, expire: float) -> None:
        """Schedule ``ident`` to expire at ``expire`` (superseding any prior
        schedule).  Non-finite expiries (``inf`` -- pinned or TTL-less
        replicas) just cancel the previous schedule."""
        gen = self._bump(ident)
        if not math.isfinite(expire):
            self._armed.pop(ident, None)
            return
        self._armed[ident] = expire
        self._seq += 1
        heapq.heappush(self._heap, (expire, order, self._seq, gen, ident))

    def disarm(self, ident: Hashable) -> None:
        """Cancel ``ident``'s schedule (replica dropped / object deleted)."""
        self._bump(ident)
        self._armed.pop(ident, None)

    def armed_expire(self, ident: Hashable) -> Optional[float]:
        """The currently scheduled expiry of ``ident`` (None = not armed)."""
        return self._armed.get(ident)

    def peek(self) -> Optional[float]:
        """Earliest armed expiry, or None if nothing is scheduled.  Stale
        head entries are discarded as a side effect."""
        while self._heap:
            expire, _order, _seq, gen, ident = self._heap[0]
            if self._gen.get(ident) != gen:
                heapq.heappop(self._heap)
                self.n_stale += 1
                continue
            return expire
        return None

    def pop_due(self, now: float) -> Iterator[Tuple[float, Hashable]]:
        """Yield ``(expire, ident)`` for every armed entry with
        ``expire <= now``, in ``(expire, order, insertion)`` order.  Each
        yielded entry is consumed; entries the consumer re-arms at a time
        still ``<= now`` are yielded again (lazy re-arm semantics)."""
        while self._heap and self._heap[0][0] <= now:
            expire, _order, _seq, gen, ident = heapq.heappop(self._heap)
            if self._gen.get(ident) != gen:
                self.n_stale += 1
                continue
            self._bump(ident)
            del self._armed[ident]
            self.n_pops += 1
            yield expire, ident

    def pop_due_batch(self, now: float) -> List[Tuple[float, Hashable]]:
        """One drain *round*: consume every entry due at call time and return
        them as a list in ``(expire, order, insertion)`` order.

        Unlike :meth:`pop_due`, the consumer's reaction is not interleaved
        per entry -- it processes the whole round, and anything it re-armed
        back under ``now`` surfaces in the *next* round (callers loop until
        an empty round).  Round-based draining is outcome-identical to the
        generator: guard re-arms (sole-copy / unavailable-region / FP
        minimums) can never become droppable within one drain -- the
        unavailable set is constant and replica counts only shrink -- so
        every actual drop happens on an entry's first pop, in heap order,
        in both schedules.  Batching exists so consumers can vectorize the
        per-round ledger charges.
        """
        out: List[Tuple[float, Hashable]] = []
        heap = self._heap
        while heap and heap[0][0] <= now:
            expire, _order, _seq, gen, ident = heapq.heappop(heap)
            if self._gen.get(ident) != gen:
                self.n_stale += 1
                continue
            self._bump(ident)
            del self._armed[ident]
            self.n_pops += 1
            out.append((expire, ident))
        return out


class KeyInterner:
    """Stable dense object ids for arbitrary string keys.

    Policies and the expiry ordering key state by an integer object id.  The
    simulator derives it as ``int(op.key)`` from trace replay, so numeric
    keys MUST map to their integer value for the two planes to index the
    same statistics.  Non-numeric keys (live clients are not restricted to
    trace-shaped keys) get dense ids in first-use order, offset far above
    any realistic trace oid so the two id spaces never collide and the
    cross-plane ``(expire, oid, region)`` expiry order stays deterministic.
    """

    #: First dense id handed to a non-numeric key (2**53: above any trace
    #: oid, still exactly representable if a caller round-trips via float).
    BASE = 1 << 53

    __slots__ = ("_ids",)

    def __init__(self) -> None:
        self._ids: Dict[str, int] = {}

    def __len__(self) -> int:
        """Number of interned (non-numeric) keys."""
        return len(self._ids)

    def intern(self, key: str) -> int:
        if key.isdigit():
            return int(key)
        oid = self._ids.get(key)
        if oid is None:
            oid = self.BASE + len(self._ids)
            self._ids[key] = oid
        return oid

    def peek(self, key: str) -> Optional[int]:
        """Non-mutating :meth:`intern`: the id ``key`` already maps to, or
        ``None`` for a non-numeric key never interned.  No id is allocated
        -- callers that look ahead (e.g. routing-hint preparation over a
        chunk of future requests) use this so they cannot disturb the
        first-use allocation order both planes' dense ids depend on."""
        if key.isdigit():
            return int(key)
        return self._ids.get(key)
