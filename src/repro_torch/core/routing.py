"""Array-backed GET routing: vectorized ``choose_get_source`` over DATA chunks.

``api.choose_get_source`` resolves one GET at a time: two dict comprehensions
(reachable, alive) plus a ``min`` over holder regions.  At replay scale that
scalar hop dominates the DATA hot loop, so this module keeps the routing
inputs as dense float64 CPU tensors and answers a whole chunk of GETs in one
masked argmin:

* ``price[src, dst]``   -- the region x region egress-price matrix lifted
  from ``CostModel`` once at construction (prices are immutable per run);
* ``expire[row, src]``  -- per-object replica-expiry vectors (``-inf`` means
  "no committed replica", ``+inf`` means pinned/base replica), one row per
  object id, rows allocated densely on first placement;
* ``outage[src]``       -- the region-down mask flipped by the chaos plane.

The committed-holder bitmask is not stored separately: it is exactly
``expire != -inf``, so every mutation is a single cell write.

Decision identity with the scalar path
--------------------------------------
The region axis is ``sorted(cost.region_names())``.  The scalar tie-break is
``min(holders, key=lambda h: (egress_price(h, dst), h))`` -- price first,
then region *name*.  Because the axis is name-sorted, the first-minimum
index that ``torch.argmin`` returns on the CPU (the same convention
``repro_torch.kernels.ref.canonical_argmin`` pins for the TTL surface) lands
on exactly the lexicographically-smallest cheapest region.  The argmin stays
on the CPU: a CUDA argmin is not documented to keep that tie-break.  No tolerance band is
needed here: both paths read the *same* float from the *same* price table,
so equal prices are bit-equal, never merely close.

The scalar ``choose_get_source`` survives as the reference oracle, selected
via ``ROUTING_ENGINES`` exactly like ``ttl_policy.TTL_ENGINES`` selects the
TTL refresh implementation; tests drive whole replays under both engines and
assert identical decision streams.

Staleness protocol
------------------
Routing for a chunk is computed *at chunk formation time*, but mutations
(PUT/DELETE/expiry/re-arm) can land mid-chunk before a routed GET dispatches.
Every row carries a mutation counter (``ver``); ``route_chunk`` snapshots it
and the consumer honors a hint only while ``ver[row]`` still matches --
otherwise it falls back to the scalar oracle for that one request.  Outage
flips and epoch swaps are chunk *boundaries* by spine construction
(``engine.EventSpine.iter_batches``), so the outage mask can never go stale
inside a chunk.

One refinement keeps the protocol from degenerating under zipfian skew
(where the common mutation is a GET re-arming the TTL of the very object the
next GET reads): a pure expiry update is *decision-invisible* to the rest of
the chunk when both the old and the new expiry lie beyond the chunk's last
routed timestamp -- ``expire > now`` then holds for every remaining request
either way, and neither membership, size, nor the outage mask moved.
``route_chunk`` records that horizon and :meth:`RoutingMatrix.set_replica`
skips the version bump exactly in that case; every membership change
(placement, drop, delete) and every expiry move that could cross a remaining
request's ``now`` still invalidates.

The mutation funnel writes one cell per event.  Those scalar writes go
through numpy views of the tensors' own storage (``Tensor.numpy()`` shares
memory): a torch element write pays ~8 us of dispatch on an x86 CPU host, a
numpy one ~0.5 us, and the funnel runs once per GET.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .costmodel import GB, CostModel

__all__ = [
    "ROUTING_ENGINES",
    "ROUTE_OK",
    "ROUTE_NO_KEY",
    "ROUTE_UNAVAILABLE",
    "ROUTE_INVALID",
    "VEC_ROUTE_MIN",
    "RouteHints",
    "RoutingMatrix",
    "resolve_routing_engine",
]

#: Routing engine registry, mirroring ``ttl_policy.TTL_ENGINES``: "matrix" is
#: the vectorized tensor path, "python" the scalar ``api.choose_get_source``
#: reference oracle, "auto" resolves to the fastest available ("matrix").
ROUTING_ENGINES: Tuple[str, ...] = ("auto", "matrix", "python")

#: Per-request route status codes (mirror ``api.choose_get_source``'s
#: outcomes; INVALID marks entries the consumer must re-route scalar-side).
ROUTE_OK = 0
ROUTE_NO_KEY = 1          # no committed replica anywhere -> NoSuchKey
ROUTE_UNAVAILABLE = 2     # committed holders exist, all down -> ServiceUnavailable
ROUTE_INVALID = 3         # not routed (unknown object / versioned read / ...)

#: Minimum GETs in a chunk before the vectorized path engages: below this
#: the tensor fixed costs exceed the scalar loop.  Decision-identical either
#: way.
VEC_ROUTE_MIN = 8

INF = float("inf")
_NEG_INF = float("-inf")
F64 = torch.float64
I64 = torch.int64


def resolve_routing_engine(engine: str) -> str:
    """Validate and resolve a ``ROUTING_ENGINES`` name ("auto" -> "matrix")."""
    if engine not in ROUTING_ENGINES:
        raise ValueError(
            f"unknown routing engine {engine!r}; expected one of {ROUTING_ENGINES}"
        )
    return "matrix" if engine == "auto" else engine


class RouteHints:
    """Chunk-formation-time routing answers for the GETs of one DATA chunk.

    Parallel plain-Python lists (``.tolist()``-ed once, so the per-request
    consume path touches no tensors), indexed by GET ordinal ``k`` -- the
    k-th GET of the chunk, in event order.  ``vers[k]`` snapshots the
    object's row mutation counter; the consumer must re-check it against the
    live matrix at dispatch and fall back to the scalar oracle on mismatch.

    ``op_cost[k]`` is valid whenever the entry was routed at all (it depends
    only on the destination region); ``egress[k]`` and ``srcs``/``hits`` are
    only meaningful while the snapshot is fresh and ``status[k]`` is
    ``ROUTE_OK``.
    """

    __slots__ = ("rows", "vers", "live_ver", "status", "srcs", "hits",
                 "egress", "op_cost")

    def __init__(self, rows, vers, live_ver, status, srcs, hits, egress,
                 op_cost):
        self.rows: List[int] = rows
        self.vers: List[int] = vers
        #: The matrix's live counter list (shared reference, not a copy):
        #: freshness check is ``live_ver[rows[k]] == vers[k]``.
        self.live_ver: List[int] = live_ver
        self.status: List[int] = status
        self.srcs: List[Optional[str]] = srcs
        self.hits: List[bool] = hits
        self.egress: List[float] = egress
        self.op_cost: List[float] = op_cost


class RoutingMatrix:
    """Dense tensor mirror of the routing-relevant replica state.

    Owned by the plane that mutates replicas (the ``Simulator``) and kept
    incrementally in sync: every committed-replica placement, drop, TTL
    re-arm and outage flip lands here as one cell write plus a row version
    bump.  See the module docstring for the staleness protocol.
    """

    _INITIAL_ROWS = 1024

    def __init__(self, cost: CostModel, unavailable=(),
                 latency_weight: float = 0.0) -> None:
        self.cost = cost
        # Name-sorted axis: argmin first-index tie-break == (price, name).
        self.regions: Tuple[str, ...] = tuple(sorted(cost.regions))
        self.region_index: Dict[str, int] = {
            r: i for i, r in enumerate(self.regions)
        }
        n = len(self.regions)
        self.price = torch.tensor(
            [[cost.egress_price(s, d) for d in self.regions] for s in self.regions],
            dtype=F64,
        )
        # op_cost(dst, "GET") per destination, for chunk-vectorized charges.
        self._get_price = torch.tensor(
            [cost.op_cost(r, "GET") for r in self.regions], dtype=F64
        )
        #: §6.3 latency-vs-egress knob.  The dense per-(src, dst) latency
        #: matrices are lifted from the SAME ``CostModel.latency_params``
        #: floats the scalar ``get_latency_ms`` reads, and the weighted score
        #: below replicates its expression term for term -- so equal scores
        #: are bit-equal across the two engines and the first-index argmin
        #: still lands on the scalar (score, name) tie-break winner.
        self.latency_weight = float(latency_weight)
        params = [[cost.latency_params(s, d) for d in self.regions]
                  for s in self.regions]
        self.ttfb = torch.tensor([[p[0] for p in row] for row in params],
                                 dtype=F64)
        # gbps * 1e9, pre-multiplied exactly as the scalar formula groups it.
        self._gbps9 = torch.tensor([[p[1] * 1e9 for p in row] for row in params],
                                   dtype=F64)
        self.outage = torch.zeros(n, dtype=torch.bool)
        for r in unavailable:
            self.outage[self.region_index[r]] = True
        # expire[row, src]: -inf = absent, +inf = pinned, else replica expiry.
        # sizes[row]: object size (bytes) -- all live replicas of an object
        # share the object's current size, so one scalar per row suffices.
        self._alloc(self._INITIAL_ROWS, n)
        # Row mutation counters as a plain list: bumped on the scalar hot
        # path, snapshot/compared as ints.
        self.ver: List[int] = [0] * self._INITIAL_ROWS
        self.row_of: Dict[int, int] = {}
        # Last routed timestamp of the chunk currently being consumed (see
        # "Staleness protocol"): expiry re-arms strictly beyond it on both
        # sides skip the version bump.  +inf = always bump (safe default
        # outside chunk consumption).
        self._chunk_end: float = INF

    # -- row allocation ------------------------------------------------------
    def _alloc(self, cap: int, n: int, keep: int = 0) -> None:
        expire = torch.full((cap, n), _NEG_INF, dtype=F64)
        sizes = torch.zeros(cap, dtype=F64)
        if keep:
            expire[:keep] = self.expire[:keep]
            sizes[:keep] = self.sizes[:keep]
        self.expire, self.sizes = expire, sizes
        # Views of the same storage for the scalar mutation funnel.
        self._expire_cells = expire.numpy()
        self._size_cells = sizes.numpy()

    def _grow(self) -> None:
        cap, n = self.expire.shape
        self._alloc(cap * 2, n, keep=cap)
        self.ver.extend([0] * cap)

    def _row(self, oid: int) -> int:
        row = self.row_of.get(oid)
        if row is None:
            row = len(self.row_of)
            if row >= self.expire.shape[0]:
                self._grow()
            self.row_of[oid] = row
        return row

    # -- incremental sync (the mutation funnel) ------------------------------
    def set_replica(self, oid: int, region: str, expire: float, size: float,
                    old: Optional[float] = None) -> None:
        """A committed replica was placed or its expiry re-armed.

        ``old`` is the cell's previous effective expiry when the caller
        already knows it (the replica record it just mutated); passing it
        skips a cell read on the mutation hot path.  ``None`` means "read
        it", not "absent" -- absent is ``-inf``."""
        row = self._row(oid)
        j = self.region_index[region]
        cells = self._expire_cells
        if old is None:
            old = float(cells[row, j])
        cells[row, j] = expire
        # Membership adds (old == -inf) always land here; pure re-arms only
        # bump when the move could flip aliveness for a remaining request.
        # Object size can only change behind a full drop of the old
        # replicas (LWW overwrite), so it needs (re)writing only on adds.
        if old == _NEG_INF:
            self._size_cells[row] = size
            self.ver[row] += 1
        elif old <= self._chunk_end or expire <= self._chunk_end:
            self.ver[row] += 1

    def drop_replica(self, oid: int, region: str) -> None:
        """A committed replica was evicted/expired/deleted."""
        row = self.row_of.get(oid)
        if row is not None:
            self._expire_cells[row, self.region_index[region]] = _NEG_INF
            self.ver[row] += 1

    def drop_object(self, oid: int) -> None:
        """All replicas of an object went away at once (DELETE)."""
        row = self.row_of.get(oid)
        if row is not None:
            self._expire_cells[row, :] = _NEG_INF
            self.ver[row] += 1

    def set_outage(self, region: str, down: bool) -> None:
        """Chaos-plane transition.  Always a chunk boundary -- no version
        bump needed (no chunk's snapshot can straddle the flip)."""
        self.outage[self.region_index[region]] = down

    # -- vectorized routing --------------------------------------------------
    def route_batch(
        self, rows: torch.Tensor, dst_idx: torch.Tensor, now: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Route N GETs in one shot.

        ``rows`` are matrix row numbers (callers pass 0 for placeholder
        entries and mask the result via status), ``dst_idx`` region-axis
        indices, ``now`` request timestamps (int64 / int64 / float64 CPU
        tensors).  Returns ``(src_idx, hit, status)`` where each element
        mirrors ``api.choose_get_source``'s decision for the same inputs:

        * committed = expire != -inf; none -> ``ROUTE_NO_KEY``;
        * reachable = committed minus down regions; none -> ``ROUTE_UNAVAILABLE``;
        * alive = reachable with expire > now, falling back to all reachable
          when every reachable copy is expired (serve-stale last resort);
        * hit iff dst itself is in the alive set, else src = masked argmin
          of the dst price column (first-index == sorted-name tie-break) --
          with a non-zero ``latency_weight`` the column is the weighted
          score ``price + latency_weight * get_latency_ms`` instead,
          mirroring ``CostModel.cheapest_source``'s weighted branch.
        """
        exp = self.expire[rows]                        # [N, R]
        committed = exp != _NEG_INF
        reachable = committed & ~self.outage[None, :]
        alive = reachable & (exp > now[:, None])
        has_alive = alive.any(dim=1)
        use = torch.where(has_alive[:, None], alive, reachable)
        n = rows.shape[0]
        hit = use[torch.arange(n), dst_idx]
        score = self.price.T[dst_idx]
        if self.latency_weight:
            # get_latency_ms, same grouping as the scalar formula:
            # ttfb + (size * 8.0 / (gbps * 1e9)) * 1e3
            lat = self.ttfb.T[dst_idx] + (
                self.sizes[rows][:, None] * 8.0 / self._gbps9.T[dst_idx]
            ) * 1e3
            score = score + self.latency_weight * lat
        prices = torch.where(use, score, INF)
        src_idx = torch.argmin(prices, dim=1)
        src_idx = torch.where(hit, dst_idx, src_idx)
        status = torch.where(
            committed.any(dim=1),
            torch.where(reachable.any(dim=1), ROUTE_OK, ROUTE_UNAVAILABLE),
            ROUTE_NO_KEY,
        )
        return src_idx, hit, status

    def _index(self, oids: Sequence[int], dsts: Sequence[str]
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        row_of, region_index = self.row_of, self.region_index
        rows = torch.tensor([row_of.get(o, -1) for o in oids], dtype=I64)
        dst_idx = torch.tensor([region_index[d] for d in dsts], dtype=I64)
        return rows, dst_idx

    def choose_get_source_batch(
        self, oids: Sequence[int], dsts: Sequence[str], nows: Sequence[float]
    ) -> Tuple[List[Optional[str]], List[bool], List[int]]:
        """Name-level batch facade over :meth:`route_batch`.

        Unknown oids (never placed) report ``ROUTE_NO_KEY``, matching the
        scalar path's NoSuchKey for an empty committed set.  Returns
        ``(sources, hits, status)``; ``sources[k]`` is ``None`` unless
        ``status[k] == ROUTE_OK``.
        """
        rows, dst_idx = self._index(oids, dsts)
        now = torch.tensor(nows, dtype=F64)
        known = rows >= 0
        src_idx, hit, status = self.route_batch(
            torch.where(known, rows, 0), dst_idx, now
        )
        status = torch.where(known, status, ROUTE_NO_KEY)
        regions = self.regions
        srcs = [
            regions[s] if st == ROUTE_OK else None
            for s, st in zip(src_idx.tolist(), status.tolist())
        ]
        return srcs, (hit & known & (status == ROUTE_OK)).tolist(), status.tolist()

    # -- chunk hint preparation ---------------------------------------------
    def route_chunk(
        self, oids: Sequence[int], dsts: Sequence[str], nows: Sequence[float]
    ) -> RouteHints:
        """Prepare :class:`RouteHints` for the GETs of one DATA chunk.

        ``oids[k]``/``dsts[k]``/``nows[k]`` describe the k-th GET in event
        order.  Besides routing, this precomputes the chunk's charge vectors
        (tensor expressions that mirror the scalar charge formulas term for
        term, so each element is bit-identical to what
        ``CostModel.op_cost``/``transfer_cost`` would return -- consumers
        accumulate them one event at a time, in event order, never via a
        reduction):

        * ``op_cost[k] = get_price[dst]``                 (op_cost(dst, "GET"))
        * ``egress[k]  = price[src, dst] * (size / GB)``  (transfer_cost)
        """
        n = len(oids)
        rows, dst_idx = self._index(oids, dsts)
        now = torch.tensor(nows, dtype=F64)
        self._chunk_end = float(now[-1]) if n else INF
        known = rows >= 0
        safe_rows = torch.where(known, rows, 0)
        src_idx, hit, status = self.route_batch(safe_rows, dst_idx, now)
        status = torch.where(known, status, ROUTE_INVALID)
        egress = self.price[src_idx, dst_idx] * (self.sizes[safe_rows] / GB)
        op_cost = self._get_price[dst_idx]
        ver = self.ver
        rows_l = rows.tolist()
        vers = [ver[r] if r >= 0 else -1 for r in rows_l]
        regions = self.regions
        srcs = [regions[s] for s in src_idx.tolist()]
        return RouteHints(
            rows_l,
            vers,
            ver,
            status.tolist(),
            srcs,
            hit.tolist(),
            egress.tolist(),
            op_cost.tolist(),
        )
