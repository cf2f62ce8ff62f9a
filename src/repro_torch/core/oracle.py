"""Trace-backed future knowledge for clairvoyant policies (§3.1.1, §6.2.2).

The paper's headline comparison is made against *oracle* baselines: the
clairvoyant greedy policy (CGP, §3.1.1 -- Belady adapted to cost, keeps a
replica iff the next GET arrives within ``T_even``) and SPANStore [SOSP'13]
(§6.2.2 -- an hourly replica-set solver fed each epoch's workload in
advance).  Both consume the :class:`~repro_torch.core.policies.Oracle` interface;
this module provides the one concrete implementation both verification
planes share: a :class:`TraceOracle` precomputed from the
:class:`~repro_torch.core.traces.Trace` before replay starts.

Both the :class:`~repro_torch.core.simulator.Simulator` (which builds its own
oracle in ``run()``) and a live
:class:`~repro.core.virtual_store.VirtualStore` (``VirtualStore(policy=...,
oracle=...)``) consume this class, so the differential replay harness
(:mod:`repro.core.replay`) can diff oracle-backed policies exactly like the
online ones -- each plane derives an equivalent oracle from the same trace,
and the per-GET decisions diff proves the derivations agree.  That is what
makes every baseline of the paper's evaluation table verifiable on the live
plane, not just estimated in simulation.

Contents:

* ``next_get_after(obj, region, now)`` -- next-GET lookahead: the sorted
  per-``(obj, region)`` GET-time arrays CGP binary-searches;
* ``gets_in_window(region, t0, t1)`` -- per-object GET count / bytes inside
  a window (the generic epoch-solver query);
* ``epoch_summary(idx)`` -- the per-epoch ``{bucket: {region: bytes}}``
  GET/PUT summaries SPANStore's solver consumes, pre-bucketed at
  construction when ``epoch_len`` is given (epoch boundaries themselves are
  emitted by the :class:`~repro_torch.core.engine.EventSpine`).

Construction is vectorized (one ``lexsort`` over the trace's GET events),
so building the oracle for a 100k-event trace costs milliseconds.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from .api import GetRequest
from .policies import Oracle
from .traces import OP_GET, Trace

INF = float("inf")

__all__ = ["TraceOracle"]


class TraceOracle(Oracle):
    """Future knowledge precomputed from a :class:`~repro_torch.core.traces.Trace`.

    ``next_access`` maps ``(obj, region) -> sorted np.ndarray of GET
    times``; ``sizes`` (optional) carries the aligned per-GET byte sizes;
    ``epoch_summaries`` (optional) maps ``epoch_idx -> (get_bytes,
    put_bytes)`` in SPANStore's ``{bucket: {region: bytes}}`` shape.

    Build one with :meth:`from_trace` and attach it to the live plane at
    construction time (the simulator builds its own inside ``run()``)::

        oracle = TraceOracle.from_trace(trace, epoch_len=policy.epoch)
        store = VirtualStore(cost, backends, meta, policy=policy,
                             oracle=oracle)
    """

    def __init__(
        self,
        next_access: Dict[Tuple[int, str], np.ndarray],
        sizes: Optional[Dict[Tuple[int, str], np.ndarray]] = None,
        epoch_len: Optional[float] = None,
        epoch_summaries: Optional[Dict[int, Tuple[dict, dict]]] = None,
    ):
        super().__init__(next_access)
        self._sizes = sizes or {}
        self.epoch_len = epoch_len
        self._epochs = epoch_summaries or {}

    # -- construction --------------------------------------------------------
    @classmethod
    def from_trace(cls, trace, epoch_len: Optional[float] = None,
                   interner=None) -> "TraceOracle":
        """Precompute the lookahead tables for ``trace``.  Pass
        ``epoch_len`` (seconds) to additionally bucket the workload into the
        per-epoch summaries an epoch solver (SPANStore) consumes.

        By default the table is keyed by the trace's raw integer object ids
        -- the ids the Simulator derives as ``int(op.key)``.  The *live*
        plane keys policy state by interned ids
        (:class:`~repro_torch.core.expiry.KeyInterner`), which equal the raw ids
        only for numeric keys; pass the consuming MetadataServer's
        ``interner`` to key the table by the interned id of each request's
        actual key instead, so clairvoyant lookups stay correct even when a
        Trace subclass rewrites ``iter_requests`` keys to arbitrary strings
        (the oracle then walks ``trace.iter_requests()``, which must stay
        1:1 and in-order with ``trace.events``).  A canonical
        :class:`~repro_torch.core.traces.Trace` spells keys as ``str(obj)``, whose
        interned id IS the raw id -- so it keeps the vectorized fast path
        even with an interner; only overridden ``iter_requests`` (or
        negative raw ids) pay for the per-request walk."""
        ev = trace.events
        epochs = (build_epoch_summaries(trace, epoch_len)
                  if epoch_len is not None else None)
        table: Dict[Tuple[int, str], np.ndarray] = {}
        sizes: Dict[Tuple[int, str], np.ndarray] = {}
        needs_walk = interner is not None and (
            type(trace).iter_requests is not Trace.iter_requests
            or (len(ev) and int(ev["obj"].min()) < 0))
        if needs_walk:
            acc_t: Dict[Tuple[int, str], list] = {}
            acc_s: Dict[Tuple[int, str], list] = {}
            for req, row in zip(trace.iter_requests(), ev):
                if not isinstance(req, GetRequest):
                    continue
                key = (interner.intern(req.key), req.region)
                # events are time-sorted, so per-key appends stay sorted
                acc_t.setdefault(key, []).append(float(req.at))
                acc_s.setdefault(key, []).append(float(row["size"]))
            table = {k: np.asarray(v) for k, v in acc_t.items()}
            sizes = {k: np.asarray(v) for k, v in acc_s.items()}
            return cls(table, sizes=sizes, epoch_len=epoch_len,
                       epoch_summaries=epochs)
        mask = ev["op"] == OP_GET
        objs = ev["obj"][mask]
        regs = ev["region"][mask]
        ts = ev["t"][mask]
        szs = ev["size"][mask]
        order = np.lexsort((ts, regs, objs))
        objs, regs, ts, szs = objs[order], regs[order], ts[order], szs[order]
        if len(objs):
            bounds = np.nonzero(np.diff(objs) | np.diff(regs))[0] + 1
            starts = np.concatenate([[0], bounds])
            ends = np.concatenate([bounds, [len(objs)]])
            for s, e in zip(starts, ends):
                key = (int(objs[s]), trace.regions[int(regs[s])])
                table[key] = ts[s:e]
                sizes[key] = szs[s:e]
        return cls(table, sizes=sizes, epoch_len=epoch_len,
                   epoch_summaries=epochs)

    # -- queries -------------------------------------------------------------
    # next_get_after is inherited from Oracle (binary search over _na).

    def gets_in_window(
        self, region: str, t0: float, t1: float
    ) -> Dict[int, Tuple[int, float]]:
        """``{obj: (n_gets, total_bytes)}`` for GETs landing at ``region``
        within ``[t0, t1)`` -- the generic form of the epoch-solver query."""
        out: Dict[int, Tuple[int, float]] = {}
        for (obj, reg), times in self._na.items():
            if reg != region:
                continue
            lo = int(np.searchsorted(times, t0, side="left"))
            hi = int(np.searchsorted(times, t1, side="left"))
            if hi > lo:
                sz = self._sizes.get((obj, reg))
                total = float(sz[lo:hi].sum()) if sz is not None else 0.0
                out[obj] = (hi - lo, total)
        return out

    def epoch_summary(self, idx: int) -> Tuple[dict, dict]:
        """The (get_bytes, put_bytes) ``{bucket: {region: bytes}}`` pair for
        epoch ``idx`` -- what SPANStore's per-epoch solver is fed.  Empty
        summaries for epochs with no events (or when the oracle was built
        without ``epoch_len``)."""
        return self._epochs.get(idx, ({}, {}))


def build_epoch_summaries(trace, epoch: float) -> Dict[int, Tuple[dict, dict]]:
    """{epoch_idx: ({bucket: {region: get_bytes}}, {bucket: {region:
    put_bytes}})} for the SPANStore oracle solver -- the *upcoming* epoch's
    workload, keyed the way :meth:`TraceOracle.epoch_summary` serves it."""
    ev = trace.events
    out: Dict[int, Tuple[dict, dict]] = {}
    eidx = (ev["t"] // epoch).astype(np.int64)
    for i in range(len(ev)):
        e = int(eidx[i])
        gets, puts = out.setdefault(e, ({}, {}))
        bucket = trace.buckets[int(ev["bucket"][i])]
        region = trace.regions[int(ev["region"][i])]
        d = gets if int(ev["op"][i]) == OP_GET else puts
        d.setdefault(bucket, {}).setdefault(region, 0.0)
        d[bucket][region] += float(ev["size"][i])
    return out
