"""The virtual-time event spine: one ordered stream for both planes.

Trace replay needs five kinds of events interleaved on a single virtual
timeline:

* **data events** -- the trace's typed request objects (clocked by ``.at``);
* **expiry pops** -- replicas coming due off the shared
  :class:`~repro_torch.core.expiry.ExpiryIndex` (the §3.2 lazy expiration heap);
* **scan ticks** -- the §4.2 periodic maintenance hook
  (``Policy.periodic``, pending-upload rollback), every ``scan_interval``;
* **epoch boundaries** -- SPANStore's solver re-runs (fired at the first
  data event of each new epoch, as the solver sees the epoch's workload);
* **outage transitions** -- the §6.4 failure plane: an
  :class:`OutageSchedule` compiles ``(region, down_t, up_t)`` windows into
  ``REGION_DOWN``/``REGION_UP`` timer events, so both planes flip a
  region's availability at the identical point in the stream.

Before this module each plane hand-rolled the interleaving (the simulator
around its private heap, the replay driver around a full eviction scan
before *every* event -- O(objects) per event).  :class:`EventSpine` owns the
merge, so both planes process timers and expirations in the identical order
by construction, and the live plane's per-event work drops to O(expired).

Ordering contract at a shared timestamp ``t`` (matching the historical
driver loops exactly):

  1. outage transitions due at or before any drain boundary fire first --
     a region's availability flips *before* expiries at the same instant
     are judged (the sole-reachable-copy guard must see the new state), and
     before ticks, epoch boundaries, and the data event; at one timestamp
     ``REGION_DOWN`` precedes ``REGION_UP`` (recovery logic sees the
     freshest unavailability), ties broken by region name;
  2. expiries due at or before a scan tick pop next, then the tick fires;
  3. all ticks ``<= t`` fire before anything else at ``t``;
  4. an epoch boundary fires next (before the pre-event drain -- the solver
     prunes replica sets *before* lazily expired replicas are collected);
  5. expiries due ``<= t`` pop;
  6. the data event dispatches.

After the last data event, remaining outage transitions and due expiries
fire at the horizon and a final ``END`` event closes the stream (storage
flush / ledger finalize).

Paper anchors: the lazy TTL expiration being sequenced here is §3.2's
"expiration happens lazily off a heap" machinery; the reason one shared
spine matters is §5's differential claim -- "simulated costs match what the
live path would be billed" is only checkable if both planes observe timers
in one order.  See :mod:`repro.core.replay` for a worked example pushing a
workload through both spine consumers and diffing the result.
"""

from __future__ import annotations

import dataclasses
from typing import (
    Dict, FrozenSet, Hashable, Iterable, Iterator, List, Optional, Sequence,
    Tuple,
)

from .expiry import ExpiryIndex

__all__ = [
    "EventSpine", "SpineEvent", "SpineBatch", "OutageSchedule",
    "OutageWindow",
    "EXPIRE", "TICK", "EPOCH", "DATA", "END", "REGION_DOWN", "REGION_UP",
]

EXPIRE = "expire"   # one replica came due: ident identifies it, t = expiry
TICK = "tick"       # periodic maintenance boundary (Policy.periodic)
EPOCH = "epoch"     # SPANStore epoch boundary: re-solve replica sets
DATA = "data"       # a trace request: dispatch it
END = "end"         # stream closed at the horizon: flush open lifetimes
REGION_DOWN = "region_down"   # §6.4 failure plane: region goes dark
REGION_UP = "region_up"       # ... and recovers


@dataclasses.dataclass
class SpineEvent:
    kind: str
    t: float
    request: object = None          # DATA: the typed api request
    ident: Optional[Hashable] = None  # EXPIRE: the ExpiryIndex ident
    epoch: int = -1                 # EPOCH: the new epoch index
    region: Optional[str] = None    # REGION_DOWN / REGION_UP: which region


@dataclasses.dataclass
class SpineBatch:
    """One chunk of the batched stream (:meth:`EventSpine.iter_batches`).

    ``DATA`` batches carry a run of consecutive trace requests with no tick,
    epoch, or outage boundary between them; ``EXPIRE`` batches carry one
    drain round off the :class:`ExpiryIndex`; every other kind is a
    singleton carrying the same payload as the scalar :class:`SpineEvent`.
    """

    kind: str
    t: float
    requests: Optional[List] = None              # DATA: the request run
    pops: Optional[List[Tuple[float, Hashable]]] = None  # EXPIRE: one round
    epoch: int = -1                              # EPOCH: new epoch index
    region: Optional[str] = None                 # REGION_DOWN / REGION_UP

    def gets(self) -> List:
        """The chunk's GET requests, in event order -- the slice both
        planes hand to ``RoutingMatrix.route_chunk`` for vectorized
        routing (exact-type match: traces never subclass request types)."""
        from .api import GetRequest
        return [r for r in self.requests if type(r) is GetRequest]


@dataclasses.dataclass(frozen=True)
class OutageWindow:
    """One region outage: ``region`` is unreachable over [``down_t``,
    ``up_t``) -- its replicas cannot serve GETs, PUTs cannot land there,
    and its physical bytes cannot be deleted."""

    region: str
    down_t: float
    up_t: float


class OutageSchedule:
    """A set of region-outage windows, compiled into the ``REGION_DOWN`` /
    ``REGION_UP`` transition stream the :class:`EventSpine` merges in.

    Windows are normalized at construction: clipped to ``t >= 0``, empty
    windows dropped, and overlapping/abutting windows of the same region
    merged -- so per region the transitions strictly alternate
    down/up.  Transitions are ordered ``(t, DOWN-before-UP, region)``; both
    planes consume the identical sequence, which is what makes outage
    reactions (failover routing, deferred base sync, the reachable-copy
    expiry guard) differentially verifiable.
    """

    def __init__(self, windows: Iterable[OutageWindow]) -> None:
        per_region: Dict[str, List[Tuple[float, float]]] = {}
        for w in windows:
            down = max(0.0, float(w.down_t))
            up = float(w.up_t)
            if up <= down:
                continue
            per_region.setdefault(w.region, []).append((down, up))
        merged: List[OutageWindow] = []
        for region, spans in per_region.items():
            spans.sort()
            cur_d, cur_u = spans[0]
            for d, u in spans[1:]:
                if d <= cur_u:                  # overlap / abut: merge
                    cur_u = max(cur_u, u)
                else:
                    merged.append(OutageWindow(region, cur_d, cur_u))
                    cur_d, cur_u = d, u
            merged.append(OutageWindow(region, cur_d, cur_u))
        self.windows: Tuple[OutageWindow, ...] = tuple(
            sorted(merged, key=lambda w: (w.down_t, w.up_t, w.region)))

    def __len__(self) -> int:
        return len(self.windows)

    def __bool__(self) -> bool:
        return bool(self.windows)

    def regions(self) -> Tuple[str, ...]:
        return tuple(sorted({w.region for w in self.windows}))

    def transitions(self) -> List[Tuple[float, str, str]]:
        """The ordered transition stream: ``(t, kind, region)`` with kind in
        ``(REGION_DOWN, REGION_UP)``, sorted ``(t, DOWN-first, region)``."""
        evs: List[Tuple[float, int, str, str]] = []
        for w in self.windows:
            evs.append((w.down_t, 0, w.region, REGION_DOWN))
            evs.append((w.up_t, 1, w.region, REGION_UP))
        evs.sort()
        return [(t, kind, region) for (t, _rank, region, kind) in evs]

    def is_down(self, region: str, t: float) -> bool:
        """Is ``region`` inside an outage window at time ``t``?  (down at
        ``down_t``, back up at ``up_t`` -- half-open windows.)"""
        return any(w.region == region and w.down_t <= t < w.up_t
                   for w in self.windows)

    def unavailable_at(self, t: float) -> FrozenSet[str]:
        return frozenset(w.region for w in self.windows
                         if w.down_t <= t < w.up_t)

    def max_concurrent_down(self, regions: Sequence[str]) -> int:
        """Worst-case number of simultaneously-down regions (schedules used
        for differential replay should keep this < len(regions): a full
        blackout 503s PUTs, after which the planes legitimately diverge on
        the downstream missing-key errors the same way invalid traces do)."""
        worst = down = 0
        for _t, kind, region in self.transitions():
            if region not in regions:
                continue
            down += 1 if kind == REGION_DOWN else -1
            worst = max(worst, down)
        return worst


class EventSpine:
    """Merge ``requests`` (typed api objects with ``.at`` set) with timer
    and expiry events into one ordered virtual-time stream.

    The spine *drives* the attached :class:`ExpiryIndex`: every yielded
    ``EXPIRE`` event is already consumed from the index, and the consumer's
    reaction (drop vs. re-arm) is observed before the next pop -- so an FP
    sole-copy re-arm that lands back inside the drain window pops again,
    exactly like the historical "re-arm until clear" loops.
    """

    def __init__(
        self,
        requests: Iterable,
        expiry: ExpiryIndex,
        scan_interval: float,
        epoch_len: Optional[float] = None,
        horizon: float = 0.0,
        outages: Optional[OutageSchedule] = None,
    ) -> None:
        self.requests = requests
        self.expiry = expiry
        self.scan_interval = scan_interval
        self.epoch_len = epoch_len
        self.horizon = horizon
        self.outages = outages

    def _drain_outages(self, now: float) -> Iterator[SpineEvent]:
        # Outage transitions flip availability before coincident expiries
        # are judged (contract step 1): the sole-reachable-copy guard and
        # the post-recovery collection both depend on this order.
        while self._transitions and self._transitions[0][0] <= now:
            t, kind, region = self._transitions.pop(0)
            yield SpineEvent(kind, t, region=region)

    def _drain(self, now: float) -> Iterator[SpineEvent]:
        yield from self._drain_outages(now)
        for texp, ident in self.expiry.pop_due(now):
            yield SpineEvent(EXPIRE, texp, ident=ident)

    def __iter__(self) -> Iterator[SpineEvent]:
        self._transitions = (list(self.outages.transitions())
                             if self.outages is not None else [])
        next_tick = self.scan_interval
        epoch_idx = -1
        for req in self.requests:
            t = float(req.at)
            while next_tick <= t:
                yield from self._drain(next_tick)
                yield SpineEvent(TICK, next_tick)
                next_tick += self.scan_interval
            yield from self._drain_outages(t)
            if self.epoch_len is not None:
                e = int(t // self.epoch_len)
                if e != epoch_idx:
                    epoch_idx = e
                    yield SpineEvent(EPOCH, t, epoch=e)
            yield from self._drain(t)
            yield SpineEvent(DATA, t, request=req)
        yield from self._drain(self.horizon)
        yield SpineEvent(END, self.horizon)

    # -- batched consumption -------------------------------------------------
    #
    # iter_batches() replaces the per-event scalar stream with chunked
    # delivery: DATA requests arrive in runs, EXPIRE pops arrive one drain
    # round at a time (so consumers can vectorize ledger charges), and the
    # timer singletons keep the scalar ordering contract.  The chunking rule
    # is purely *formation-time*: a run breaks only at boundaries knowable
    # without dispatching anything (a tick came due, an outage transition
    # came due, the epoch index changed).  Expiries can NOT be a
    # formation-time boundary, because dispatching a request inside a run
    # may arm an expiry that falls due before the run's next request
    # (TTL=0 arms at exactly t).  The consumer therefore owes the spine one
    # obligation, packaged as :meth:`drain_due`:
    #
    #   before dispatching EACH request of a DATA batch, drain due expiries
    #   up to that request's timestamp.
    #
    # With that obligation met, the batched stream observes events in
    # exactly the scalar __iter__ order -- the golden matrix pins it.

    def _expire_batches(self, now: float) -> Iterator[SpineBatch]:
        """Drain rounds at ``now``: each yielded round is fully processed by
        the consumer before the next peek, so re-arms landing back under
        ``now`` surface in a later round (lazy re-arm semantics)."""
        expiry = self.expiry
        p = expiry.peek()
        while p is not None and p <= now:
            yield SpineBatch(EXPIRE, now, pops=expiry.pop_due_batch(now))
            p = expiry.peek()

    @staticmethod
    def drain_due(expiry: ExpiryIndex, now: float, on_round) -> None:
        """The DATA-batch consumer obligation: drain every due expiry round
        before dispatching a request at ``now``.  O(1) when nothing is due
        (one heap peek) -- this is the common case inside a run."""
        p = expiry.peek()
        while p is not None and p <= now:
            on_round(expiry.pop_due_batch(now))
            p = expiry.peek()

    def iter_batches(self, max_chunk: int = 4096) -> Iterator[SpineBatch]:
        """The chunked stream.  ``max_chunk`` bounds DATA-run buffering for
        streaming traces; splitting a run is always semantics-preserving."""
        transitions = (list(self.outages.transitions())
                       if self.outages is not None else [])
        epoch_len = self.epoch_len
        next_tick = self.scan_interval
        epoch_idx = -1
        chunk: List = []

        for req in self.requests:
            t = float(req.at)
            if (next_tick > t
                    and not (transitions and transitions[0][0] <= t)
                    and (epoch_len is None
                         or int(t // epoch_len) == epoch_idx)
                    and len(chunk) < max_chunk):
                chunk.append(req)
                continue
            if chunk:
                yield SpineBatch(DATA, float(chunk[0].at), requests=chunk)
                chunk = []
            while next_tick <= t:
                while transitions and transitions[0][0] <= next_tick:
                    t0, kind, region = transitions.pop(0)
                    yield SpineBatch(kind, t0, region=region)
                yield from self._expire_batches(next_tick)
                yield SpineBatch(TICK, next_tick)
                next_tick += self.scan_interval
            while transitions and transitions[0][0] <= t:
                t0, kind, region = transitions.pop(0)
                yield SpineBatch(kind, t0, region=region)
            if epoch_len is not None:
                e = int(t // epoch_len)
                if e != epoch_idx:
                    epoch_idx = e
                    yield SpineBatch(EPOCH, t, epoch=e)
            chunk.append(req)
        if chunk:
            yield SpineBatch(DATA, float(chunk[0].at), requests=chunk)
        while transitions and transitions[0][0] <= self.horizon:
            t0, kind, region = transitions.pop(0)
            yield SpineBatch(kind, t0, region=region)
        yield from self._expire_batches(self.horizon)
        yield SpineBatch(END, self.horizon)
