#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA H100 and check it.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds every kernel of the paths from the sources in ``src/repro_torch``
(one nvcc per source for sm_90a, all started together), then runs six
phases, printing one JSON line each and stopping with a non-zero exit at the
first that fails:

  device     the card's name and power limit (nvidia-smi) and the build time;
  kernels    a controller refresh by the profiler: one copy in, one launch,
             one copy out, nothing else; then the TTL-scan kernel against its
             plain PyTorch version on the card (the CPU-test sweep shapes and
             the §6.7.3 scale): the surface within rtol 2e-5 / atol 1e-4, the
             fused decision's index exactly the plain rule's on the kernel's
             own surface, a launch without the surface and one shared
             histogram row (stride 0) equal to the full and stacked
             launches; two controls that must be caught (a raw argmin on
             2^-21 near-tie rows, a last occupied cell cut from the inputs);
             the surface and decision calls' times by CUDA events and by the
             profiler beside the plain version's and the bound, a whole
             refresh's host time, and how often its TTL index equals the
             float64 one;
  decisions  on a replay-harvested histogram corpus, every edge TTL from the
             kernel engine equals the scalar python engine's;
  replay     the main path: a large-tier 9-region zipfian trace replayed
             with SkyStore on the kernel engine (card) and on the float64
             torch engine (CPU) -- identical decisions, dollars and counters,
             one launch per refresh (and no other device op in the traced
             replay), each refresh's host time -- and the
             golden replay fixtures of the SkyStore policy reproduced with
             the kernel engine;
  flash      the three flash-attention routes against the plain version on
             the card (f32 2e-5, bf16 2e-2): the six CPU-test cases and the
             serving prefill and decode shapes on the planned route, then
             each bf16 route forced on its own cases (group 7 at D 128 in
             prefill and decode, an 8,192-key decode); and each route's time
             by CUDA events and by the profiler at its main-path shapes
             (wgmma: serving prefill; splitkv: serving decode, warm and with
             L2 flushed, and the 8,192-key decode; simt: the f32 gate's shape,
             and the bf16 serving shapes for comparison) beside the plain
             version's, the bound and scaled_dot_product_attention's;
  serve      the serving path: ``repro_torch.launch.serve`` at full width
             (llama3.2-1b, bf16, seeded random weights; 6 requests of batch
             4, 1024-token prompts, 32 generated tokens, three distinct
             prompts so the KV tier sees three misses and three hits), with
             every bf16 attention call required on a new route (wgmma
             launches = layers x prefills, splitkv launches = layers x decode
             steps, simt none), the tier's stored caches unchanged by
             decoding, a bf16 check and an f32 gate at full width: logits
             through the kernels against logits through the plain attention.

Then it prints the per-kernel summary line, the nvidia-smi line, and, last,
``{"ok": true, "device": {...}}``.  Without a CUDA device, or outside a
checkout, it exits non-zero and prints no result.  Everything too long for
the end of the output goes to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import functools
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
OUT = ROOT / "chiprun_out" / "chip_smoke.json"

#: Card peaks used for the bound (NVIDIA H100 SXM data sheet): HBM3 rate,
#: the float32 rate outside the tensor cores and the bf16 tensor-core rate.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12

RTOL, ATOL = 2e-5, 1e-4
SWEEP = [(1, 800), (3, 800), (17, 800), (64, 800), (5, 123), (2, 1024),
         (7, 123), (7, 257), (7, 900)]
E_MAIN, E_SCALE, C_MAIN = 8, 72_000, 800
DAY = 24 * 3600.0

LIBRARY_NOTE = ("no single PyTorch call computes the ExpectedCost surface, "
                "so there is no library time")

RESULT: dict = {}


def emit(phase: str, **fields) -> None:
    line = {"phase": phase, **fields}
    RESULT[phase] = line
    print(json.dumps(line), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# -- problem data, drawn with numpy as the JAX reference's tests draw it -----

@functools.lru_cache(maxsize=None)
def problem(e_dim: int, c_dim: int, seed: int):
    """Kernel inputs drawn as the reference draws them: the shape sweep of
    ``tests/test_kernels.py::_hist_problem`` and, at C = 800 with seed 0,
    the §6.7.3-scale problem of ``benchmarks/kernel_bench.py::_problem``.
    Cached, since drawing 72,000 rows takes seconds."""
    import numpy as np
    from repro_torch.core.histogram import cell_edges

    rng = np.random.default_rng(seed)
    edges = (cell_edges().numpy() if c_dim == 800
             else np.cumsum(rng.uniform(1, 100, c_dim)))
    hist = (rng.gamma(0.3, 1e9, (e_dim, c_dim))
            * (rng.random((e_dim, c_dim)) < 0.1)).astype(np.float32)
    time_w = hist * (edges[None] * rng.random((e_dim, c_dim))).astype(np.float32)
    last = (rng.gamma(0.3, 1e9, (e_dim, c_dim))
            * (rng.random((e_dim, c_dim)) < 0.05)).astype(np.float32)
    s = rng.uniform(5e-18, 5e-17, e_dim).astype(np.float32)
    n = rng.uniform(1e-11, 1e-10, e_dim).astype(np.float32)
    first = rng.gamma(1.0, 1e9, e_dim).astype(np.float32)
    return hist, time_w, last, edges.astype(np.float32), s, n, first


# -- the TTL-scan kernel -----------------------------------------------------

def ttl_scan_bound_ms(e_dim: int, c_dim: int, rows=None, surface: bool = True,
                      decision: bool = False) -> tuple:
    """Least time for one call: each input read once (``rows`` histogram
    rows of hist, time_w and last -- 1 when every edge shares one -- the
    edges and three prices a row) and each output written once (the [E, C]
    surface if asked; a decision's index, best and TTL = 0 cost a row) over
    the HBM rate, against the float32 operations over the card's float32
    peak.  Per cell: 24 operations (midpoint 2, t_hat 1, two products, six
    prefix-sum adds with the row totals, 13 in the cost expression), and 2
    more for a decision (the minimum, the threshold test).  Distinct rows
    are 16 bytes a cell with the surface, 12 without."""
    rows = e_dim if rows is None else rows
    n_bytes = 4 * (3 * rows * c_dim + c_dim + 3 * e_dim
                   + (e_dim * c_dim if surface else 0)
                   + (3 * e_dim if decision else 0))
    ops_s = (24 + 2 * decision) * e_dim * c_dim / F32_OPS_PER_S
    bytes_s = n_bytes / HBM_BYTES_PER_S
    return (1e3 * max(bytes_s, ops_s),
            "bytes" if bytes_s >= ops_s else "operations")


def cuda_ms(fn, launches_per_rep: int, reps: int = 15) -> float:
    """Median over ``reps`` of the mean per-call time of ``launches_per_rep``
    back-to-back calls, by CUDA events."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(launches_per_rep):
            fn()
        b.record()
        b.synchronize()
        per.append(a.elapsed_time(b) / launches_per_rep)
    return statistics.median(per)


def device_profile(fn) -> dict:
    """Run ``fn`` once under ``torch.profiler`` (device activity only) and
    return the host wall seconds, the seconds the device was busy (kernels,
    copies, fills) and each device op's count and mean microseconds.  The
    profiler's device tracing is untried on some hosts: if it fails or shows
    no device time, the numbers are recorded as not measured."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ops = {}
        for ev in prof.key_averages():
            us = getattr(ev, "self_device_time_total", None)
            if us is None:
                us = getattr(ev, "self_cuda_time_total", 0.0)
            if us > 0:
                ops[ev.key[:80]] = {"count": ev.count, "mean_us": us / ev.count}
    except Exception as exc:  # measurement only: never a gate
        return {"not_measured": repr(exc)[:300]}
    if not ops:
        return {"not_measured": "the profiler recorded no device time"}
    busy = sum(o["count"] * o["mean_us"] for o in ops.values()) * 1e-6
    return {"wall_s": wall, "device_busy_s": busy,
            "device_idle_share": 1.0 - busy / wall, "ops": ops}


def host_profile(fn, top: int = 12, focus: tuple = ()) -> dict:
    """Run ``fn`` once under ``cProfile``: the host's wall seconds and the
    functions with the most own time (a PyTorch op's own time is its
    dispatch and launch), and the calls, own and cumulative seconds of the
    functions whose names hold a string of ``focus``.  cProfile slows Python calls, so the
    shares, not the seconds, are what this shows."""
    import cProfile
    import pstats
    import torch

    torch.cuda.synchronize()
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.runcall(fn)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stats = pstats.Stats(prof).stats
    total = sum(st[2] for st in stats.values())
    rows = sorted(stats.items(), key=lambda kv: -kv[1][2])[:top]
    return {"wall_s": wall, "own_s_total": total, "top": [
        {"fn": f"{Path(f).name}:{line}({name})", "calls": st[1],
         "own_s": st[2]} for (f, line, name), st in rows],
        "focus": [{"fn": f"{Path(f).name}:{line}({name})", "calls": st[1],
                   "own_s": st[2], "cum_s": st[3]}
                  for (f, line, name), st in stats.items()
                  if any(key in name for key in focus)]}


def kernel_device_us(prof: dict, name: str = "ttl_scan_kernel"):
    """Mean device microseconds of the named kernel in a profile."""
    for key, op in prof.get("ops", {}).items():
        if name in key:
            return op["mean_us"]
    return None


def f64_indices(prob, chunk: int = 8000):
    """argmin of the float64 ``batched_cost_curves`` surface, by rows."""
    import torch
    from repro_torch.core.ttl_policy import batched_cost_curves

    hist, time_w, last, edges, s, n, first = prob
    out = []
    for i in range(0, hist.shape[0], chunk):
        sl = slice(i, i + chunk)
        _ttls, cost = batched_cost_curves(hist[sl], time_w[sl], last[sl],
                                          edges, first[sl], s[sl], n[sl])
        out.append(torch.argmin(cost, dim=1))
    return torch.cat(out)


def kernel_indices(prob, dev):
    """Canonical-argmin TTL indices of the kernel's own surface and TTL = 0
    column, as the controller takes them."""
    import torch
    from repro_torch.kernels.ref import canonical_argmin
    from repro_torch.kernels.ttl_scan import ttl_decision

    t = [torch.as_tensor(x, device=dev).contiguous() for x in prob]
    _idx, _best, zero, surf = ttl_decision(*t, surface=True)
    return canonical_argmin(torch.cat([zero[:, None], surf], dim=1))


#: Rows with known decisions, exact in float32 (tests/test_torch_ttl_scan.py
#: builds the same): s = 1, n = 2^22, first = 0, edges 1, 2, ..., C.  One
#: byte re-read in cell TIE_K1 with t_hat 0 and one in cell K2 with t_hat T2:
#: the cells from TIE_K1 cost A + (j - TIE_K1), A = 2^22 + TIE_K1 + 1, and
#: the cells from K2 cost T2 = A - delta.  delta 2 is 2^-21 of A: the earlier
#: candidate is inside the tie band and must win, where a raw argmin takes
#: the later; delta 8 is 2^-19: the later must win.
TIE_N, TIE_K1 = 2.0 ** 22, 10


def tie_rows(e_dim: int, c_dim: int, delta: float):
    """(inputs, wanted index, raw-argmin index) for ``e_dim`` equal rows."""
    import numpy as np

    k2 = min(c_dim - 3, 700)
    hist = np.zeros((e_dim, c_dim), np.float32)
    time_w = np.zeros((e_dim, c_dim), np.float32)
    hist[:, TIE_K1] = hist[:, k2] = 1.0
    time_w[:, k2] = TIE_N + TIE_K1 + 1 - delta
    prob = (hist, time_w, np.zeros_like(hist),
            np.arange(1, c_dim + 1, dtype=np.float32),
            np.ones(e_dim, np.float32), np.full(e_dim, TIE_N, np.float32),
            np.zeros(e_dim, np.float32))
    return prob, (TIE_K1 + 1 if delta < 4 else k2 + 1), k2 + 1


def surface_excess(got, want) -> float:
    """Largest excess of |got - want| over atol + rtol |want|: > 0 fails."""
    return float(((got - want).abs() - (ATOL + RTOL * want.abs())).max())


def decision_checks(t, e_dim: int, c_dim: int) -> dict:
    """The fused decision on card tensors ``t``: its index is exactly the
    plain rule's on its own [E, C+1] surface and its cost the surface's
    there; a launch without the surface decides the same; one histogram
    shared by every row (stride 0) is bit-equal to it stacked E times."""
    import torch
    from repro_torch.kernels import ref, ttl_scan

    idx, best, zero, surf = ttl_scan.ttl_decision(*t, surface=True)
    full = torch.cat([zero[:, None], surf], dim=1).cpu()
    want = ref.canonical_argmin(full)
    index_ok = bool(torch.equal(idx.cpu().long(), want))
    cost_ok = bool(torch.equal(best.cpu(), full[torch.arange(e_dim), want]))
    bare = ttl_scan.ttl_decision(*t)
    null_ok = bare[3] is None and all(
        torch.equal(a, b) for a, b in zip(bare[:3], (idx, best, zero)))
    shared = [x[:1].expand(e_dim, c_dim) for x in t[:3]] + list(t[3:])
    stacked = [x.contiguous() for x in shared[:3]] + list(t[3:])
    a = ttl_scan.ttl_decision(*shared, surface=True)
    b = ttl_scan.ttl_decision(*stacked, surface=True)
    shared_ok = all(torch.equal(x, y) for x, y in zip(a, b))
    _, _, p_zero, _ = ref.ttl_decision_ref(*t)
    return {"index_equals_plain_rule": index_ok, "cost_at_index": cost_ok,
            "null_surface_equal": null_ok, "shared_row_bit_equal": shared_ok,
            "zero_column_excess": surface_excess(zero, p_zero),
            "ok": index_ok and cost_ok and null_ok and shared_ok
            and surface_excess(zero, p_zero) <= 0.0}


def ttl_controls(dev) -> list:
    """Controls that must be caught: (1) on the constructed 2^-21 near-tie
    rows the raw argmin of the kernel's own surface must disagree with the
    kernel's index (which must be the earlier candidate), and at 2^-19 the
    kernel must take the later one; (2) the kernel's surface with the last
    occupied cell of row 0 cut from its inputs must fail the rtol 2e-5 /
    atol 1e-4 comparison with the plain version of the whole inputs."""
    import numpy as np
    import torch
    from repro_torch.kernels import ref, ttl_scan

    out = []
    for c_dim in (C_MAIN, 257):
        for delta in (2.0, 8.0):
            prob, want, raw = tie_rows(E_MAIN, c_dim, delta)
            t = [torch.as_tensor(x, device=dev) for x in prob]
            idx, _best, zero, surf = ttl_scan.ttl_decision(*t, surface=True)
            full = torch.cat([zero[:, None], surf], dim=1)
            k_idx = sorted(set(idx.cpu().tolist()))
            raw_idx = sorted(set(torch.argmin(full, dim=1).cpu().tolist()))
            row = {"control": f"near_tie_2^{-21 if delta < 4 else -19}",
                   "C": c_dim, "kernel_index": k_idx, "want": want,
                   "raw_argmin": raw_idx}
            if delta < 4:   # the raw argmin must be wrong here
                row["caught"] = k_idx == [want] and raw_idx == [raw]
            else:
                row["ok"] = k_idx == [want]
            out.append(row)
    prob = problem(E_MAIN, C_MAIN, seed=0)
    k = int(np.nonzero((prob[0][0] > 0) | (prob[2][0] > 0))[0].max())
    cut = [x.copy() for x in prob]
    for a in (0, 1, 2):
        cut[a][0, k] = 0.0
    got = ttl_scan.ttl_cost_surface(
        *[torch.as_tensor(x, device=dev).contiguous() for x in cut])
    want_s = ref.ttl_cost_ref(
        *[torch.as_tensor(x, device=dev).contiguous() for x in prob])
    excess = surface_excess(got, want_s)
    out.append({"control": "last_occupied_cell_cut", "row": 0, "cell": k,
                "excess_over_tol": excess, "caught": excess > 0.0})
    return out


def sass_instructions(library) -> dict:
    """Static SASS instruction count of each kernel in a built library
    (``cuobjdump -sass``), or why it was not measured: the body of the
    TTL-scan kernel's row loop is what each row costs in instructions."""
    import re

    try:
        out = subprocess.run(
            ["/usr/local/cuda/bin/cuobjdump", "-sass", str(library._target())],
            capture_output=True, text=True, timeout=120, check=True).stdout
    except Exception as exc:  # measurement only: never a gate
        return {"not_measured": repr(exc)[:300]}
    counts, name = {}, None
    for line in out.splitlines():
        m = re.match(r"\s+Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = 0
        elif name and re.match(r"\s+/\*[0-9a-f]{4}\*/", line):
            counts[name] += 1
    return counts


def refresh_host_us(fn, reps: int) -> float:
    """Median host microseconds of ``fn`` (a whole refresh: it synchronises)."""
    fn()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        walls.append(time.perf_counter() - t0)
    return 1e6 * statistics.median(walls)


#: The device ops of a controller refresh, as the profiler names them.
REFRESH_OPS = {"copy_in": "Memcpy HtoD", "launch": "ttl_scan_kernel",
               "copy_out": "Memcpy DtoH"}


def refresh_device_ops(dev, refreshes: int = 3) -> list:
    """The device ops of single kernel-engine refreshes of a (bucket,
    region)'s 8 incoming edges, by the profiler, counted by kind.  Each
    profiling session opens with a primer of four small elementwise kernels,
    synchronised: in a long process a session has been seen to miss its
    first device records, and those are then the primer's (counted apart)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.costmodel import pick_regions
    from repro_torch.core.histogram import AccessHistogram
    from repro_torch.core.ttl_policy import AdaptiveTTLController

    cat = pick_regions(9)
    dst = cat.region_names()[0]
    srcs = [r for r in cat.region_names() if r != dst]
    prob = problem(1, C_MAIN, seed=0)
    merged = AccessHistogram(
        *(torch.from_numpy(x.reshape(-1).astype("float64"))
          for x in (prob[3], *prob[:3])), float(prob[6][0]), 100)
    ctl = AdaptiveTTLController(cat, engine="kernel", device=dev)
    ctl._refresh_batched(merged, dst, srcs, "kernel")
    out = []
    for _ in range(refreshes):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            primer = torch.zeros(256, device=dev)
            for _ in range(3):
                primer.add_(1.0)
            torch.cuda.synchronize()
            ctl._refresh_batched(merged, dst, srcs, "kernel")
            torch.cuda.synchronize()
        names = [ev.name for ev in prof.events()
                 if ev.device_type == DeviceType.CUDA]
        ops = {k: sum(name in x for x in names)
               for k, name in REFRESH_OPS.items()}
        ops["primer"] = sum("elementwise" in x for x in names)
        ops["other"] = len(names) - sum(ops.values())
        out.append(ops)
    return out


def phase_kernels(dev) -> dict:
    import torch
    from repro_torch.core.costmodel import pick_regions
    from repro_torch.core.histogram import AccessHistogram
    from repro_torch.kernels import ref, ttl_scan
    from repro_torch.kernels.ops import _ttl_decide, ttl_scan_from_histograms

    def on_card(prob):
        return [torch.as_tensor(x, device=dev).contiguous() for x in prob]

    # A controller refresh is one copy in, one launch and one copy out:
    # checked first, before any other profiling session of this process.
    single = refresh_device_ops(dev)
    if not all(ops["copy_in"] == ops["launch"] == ops["copy_out"] == 1
               and ops["other"] == 0 for ops in single):
        emit("kernels", ok=False, refresh_device_ops=single)
        raise SystemExit("a controller refresh is not one copy each way and "
                         "one launch")

    # Numerics against the plain version, on the card: the surface, then the
    # decision taken from it.
    checks, max_abs = [], 0.0
    probs = [(e, c, problem(e, c, seed=e * 1000 + c)) for e, c in SWEEP]
    probs += [(e, C_MAIN, problem(e, C_MAIN, seed=0)) for e in (E_MAIN, E_SCALE)]
    for e_dim, c_dim, prob in probs:
        t = on_card(prob)
        k = ttl_scan.ttl_cost_surface(*t)
        p = ref.ttl_cost_ref(*t)
        torch.cuda.synchronize()
        err = (k - p).abs()
        excess = surface_excess(k, p)
        dec = decision_checks(t, e_dim, c_dim)
        ok = bool(torch.isfinite(k).all()) and excess <= 0.0 and dec["ok"]
        checks.append({"E": e_dim, "C": c_dim, "max_abs_err": float(err.max()),
                       "max_excess_over_tol": excess, **dec, "ok": ok})
        max_abs = max(max_abs, float(err.max()))
        if not ok:
            emit("kernels", ok=False, checks=checks)
            raise SystemExit(f"ttl_scan disagrees with its plain version at "
                             f"E={e_dim} C={c_dim}")
    controls = ttl_controls(dev)
    if not all(c.get("caught", c.get("ok")) for c in controls):
        emit("kernels", ok=False, checks=checks, controls=controls)
        raise SystemExit("a TTL-scan control was not caught")

    # Times and bounds at the main-path and the §6.7.3 shapes: the surface
    # call (distinct rows) and the decision call without the surface (at
    # E = 8 as the controller makes it: one shared histogram row).
    cat = pick_regions(9)
    pairs = [(a, b) for a in cat.region_names()
             for b in cat.region_names() if a != b]
    timings = []
    for e_dim in (E_MAIN, E_SCALE):
        prob = problem(e_dim, C_MAIN, seed=0)
        t = on_card(prob)
        main = e_dim == E_MAIN
        dec_in = ([x[:1].expand(e_dim, C_MAIN) for x in t[:3]] + t[3:]
                  if main else t)
        n_per = 200 if main else 5
        calls = {
            "surface": (lambda: ttl_scan.ttl_cost_surface(*t),
                        lambda: ref.ttl_cost_ref(*t),
                        ttl_scan_bound_ms(e_dim, C_MAIN)),
            "decision": (lambda: ttl_scan.ttl_decision(*dec_in),
                         lambda: ref.ttl_decision_ref(*dec_in),
                         ttl_scan_bound_ms(e_dim, C_MAIN,
                                           rows=1 if main else None,
                                           surface=False, decision=True)),
        }
        row = {"E": e_dim, "C": C_MAIN,
               "decision_rows": "one shared row" if main else "distinct"}
        for name, (call, plain, (bound_ms, bound_by)) in calls.items():
            ms = cuda_ms(call, n_per)
            plain_ms = cuda_ms(plain, n_per if main else 1,
                               reps=15 if main else 3)
            # Device time per launch, apart from the host's issue rate that
            # back-to-back CUDA-event timing includes at small E.
            prof = device_profile(lambda: [call() for _ in range(n_per)])
            dev_us = kernel_device_us(prof)
            row[name] = {
                "ms": ms, "plain_ms": plain_ms, "device_us": dev_us,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "share_of_bound_events": bound_ms / ms,
                "share_of_bound_device": (None if dev_us is None
                                          else 1e3 * bound_ms / dev_us)}
        row["ttl_index_agreement"] = float(
            (kernel_indices(prob, dev) == f64_indices(prob)).double().mean())
        # Whole refreshes, host clock: float64 host histograms -> float32 on
        # the card -> one launch -> decisions back.  Distinct rows through
        # ttl_scan_from_histograms (with the surface, as before), and one
        # shared histogram through the controller's decision op.
        targets = [pairs[i % len(pairs)] for i in range(e_dim)]
        edges64 = torch.from_numpy(prob[3].astype("float64"))
        h64 = [torch.from_numpy(x.astype("float64")) for x in prob[:3]]
        hists = [AccessHistogram(edges64, h64[0][i], h64[1][i], h64[2][i],
                                 float(prob[6][i]), 1) for i in range(e_dim)]
        s64 = torch.from_numpy(prob[4].astype("float64"))
        n64 = torch.from_numpy(prob[5].astype("float64"))
        reps = 50 if main else 3
        row["refresh_us_host"] = refresh_host_us(
            lambda: ttl_scan_from_histograms(hists, cat, targets, device=dev),
            reps)
        row["refresh_us_host_shared"] = refresh_host_us(
            lambda: _ttl_decide(hists[0], s64, n64, dev), reps)
        if main:   # where a shared refresh's host time goes
            row["refresh_host_profile"] = host_profile(
                lambda: [_ttl_decide(hists[0], s64, n64, dev)
                         for _ in range(200)], top=15)
        timings.append(row)
        del t, dec_in
        torch.cuda.empty_cache()
    emit("kernels", ok=True, ported=["ttl_scan"], rtol=RTOL, atol=ATOL,
         refresh_device_ops=single, checks=checks, controls=controls,
         timings=timings,
         build_log=ttl_scan.LIBRARY.log[-2000:],
         sass_instructions=sass_instructions(ttl_scan.LIBRARY),
         library_ms=None, library_note=LIBRARY_NOTE)
    return {"max_abs_err": max_abs, "timings": timings}


def harvest_corpus():
    """Histograms harvested from the port's own simulator on the CPU."""
    from repro_torch.core.costmodel import pick_regions
    from repro_torch.core.policies import make_policy
    from repro_torch.core.simulator import Simulator
    from repro_torch.core.workloads import make_workload

    cat = pick_regions(3)
    tr = make_workload("zipfian", cat.region_names(), seed=11,
                       n_objects=150, n_requests=4000)
    policy = make_policy("skystore", cat, device="cpu")
    Simulator(cat, policy, mode="FB").run(tr)
    hists = {key: roll.merged() for key, roll in policy.ctl.hists.items()
             if roll.merged().n_samples > 0}
    return cat, hists


def refresh_all(cat, hists, engine, device):
    from repro_torch.core.histogram import RollingHistogram
    from repro_torch.core.ttl_policy import AdaptiveTTLController

    ctl = AdaptiveTTLController(cat, warmup_min_samples=1, engine=engine,
                                device=device)
    for key, h in hists.items():
        roll = RollingHistogram(h.edges)
        roll.current = h.copy()
        ctl.hists[key] = roll
    for (bucket, dst) in hists:
        for src in cat.region_names():
            if src != dst:
                ctl.edge_ttl(bucket, src, dst, now=1.0)
    return {k: e.ttl_seconds for k, e in ctl.edge_ttls.items()}


def phase_decisions(dev) -> None:
    cat, hists = harvest_corpus()
    want = refresh_all(cat, hists, "python", "cpu")
    got = refresh_all(cat, hists, "kernel", dev)
    bad = [str(k) for k in want if got.get(k) != want[k]]
    ok = set(got) == set(want) and not bad
    emit("decisions", ok=ok, windows=len(hists), edges=len(want),
         ttl_mismatches=len(bad), examples=bad[:5])
    if not ok:
        raise SystemExit("kernel-engine TTLs differ from the python engine")


def phase_replay(dev) -> int:
    from repro_torch.core.costmodel import pick_regions
    from repro_torch.core.policies import make_policy
    from repro_torch.core.simulator import Simulator
    from repro_torch.core.workloads import make_workload
    from repro_torch.kernels import ttl_scan

    cat = pick_regions(9)
    trace = make_workload("zipfian", cat.region_names(), seed=7, tier="large")

    def replay(engine, device, walls=None):
        """One replay; with ``walls``, the host seconds of each controller
        refresh (``_refresh_batched``, which ends synchronised) go there."""
        policy = make_policy("skystore", cat, engine=engine, device=device)
        if walls is not None:
            make_ctl = policy._mk      # reset() makes a new controller

            def timed_ctl():
                ctl = make_ctl()
                inner = ctl._refresh_batched

                def timed(*args):
                    t0 = time.perf_counter()
                    out = inner(*args)
                    walls.append(time.perf_counter() - t0)
                    return out

                ctl._refresh_batched = timed
                return ctl

            policy._mk = timed_ctl
            policy.reset()
        sim = Simulator(cat, policy, mode="FB", track_decisions=True)
        t0 = time.perf_counter()
        report = sim.run(trace)
        secs = time.perf_counter() - t0
        return report, sim.decisions, secs, policy.ctl.n_refreshes

    walls_k, walls_t = [], []
    ttl_scan.ttl_cost_surface.launches = 0
    rep_k, dec_k, secs_k, refreshes = replay("kernel", dev, walls_k)
    launches = ttl_scan.ttl_cost_surface.launches
    rep_t, dec_t, secs_t, _ = replay("torch", "cpu", walls_t)
    # A third, traced run of the kernel engine: where the card's time goes
    # and how long it idles (the two runs above are untraced); a fourth under
    # cProfile: how much of a refresh's host time waits on the card.
    prof = device_profile(lambda: replay("kernel", dev))
    host = host_profile(lambda: replay("kernel", dev), top=15, focus=(
        "_refresh_batched", "_ttl_decide", "_launch", "synchronize",
        "'copy_'"))
    n_ev = len(trace.events)
    same = (dec_k == dec_t, rep_k.components() == rep_t.components(),
            rep_k.counters() == rep_t.counters())
    # Device ops of the traced replay: no other op, and none of a refresh's
    # three more often than once a refresh (exactly one each is the kernels
    # phase's check on single refreshes: a long trace may drop a record).
    traced = {k: sum(o["count"] for key, o in prof.get("ops", {}).items()
                     if name in key) for k, name in REFRESH_OPS.items()}
    traced["other"] = sum(o["count"] for key, o in prof.get("ops", {}).items()
                          if not any(n in key for n in REFRESH_OPS.values()))
    traced_ok = "ops" not in prof or (traced["other"] == 0 and all(
        traced[k] <= refreshes for k in REFRESH_OPS))
    golden = golden_skystore(dev)
    ok = (all(same) and launches == refreshes > 0 and traced_ok
          and all(g["ok"] for g in golden))
    emit("replay", ok=ok, events=n_ev, gets=rep_k.n_get,
         decisions_identical=same[0], components_identical=same[1],
         counters_identical=same[2], refreshes=refreshes,
         kernel_launches=launches, traced_device_ops=traced,
         events_per_s={"kernel_cuda": n_ev / secs_k, "torch_cpu": n_ev / secs_t},
         refresh_us_host_median={
             "kernel_cuda": 1e6 * statistics.median(walls_k),
             "torch_cpu": 1e6 * statistics.median(walls_t)},
         components=rep_k.components(), counters=rep_k.counters(),
         traced_kernel_replay=prof, profiled_kernel_replay=host,
         golden=golden)
    if not ok:
        raise SystemExit("main-path replay check failed")
    return launches


def golden_skystore(dev) -> list:
    """The SkyStore golden replay fixtures, reproduced on the kernel engine
    (sim block within 1e-9 relative, counters and availability exact)."""
    from repro_torch.core.costmodel import pick_regions
    from repro_torch.core.policies import make_policy
    from repro_torch.core.simulator import Simulator
    from repro_torch.core.workloads import make_outage_schedule, make_workload

    cat = pick_regions(3)
    out = []
    for path in sorted((ROOT / "tests" / "golden" / "replay")
                       .glob("*__skystore.json")):
        want = json.loads(path.read_text())
        wl, _, outage = path.stem.split("__")[0].partition("@")
        trace = make_workload(wl, cat.region_names(), seed=7)
        sched = (make_outage_schedule(outage, cat.region_names(),
                                      trace.duration, seed=7)
                 if outage else None)
        policy = make_policy("skystore", cat, engine="kernel", device=dev)
        rep = Simulator(cat, policy, mode="FB", scan_interval=DAY,
                        track_decisions=True, outages=sched).run(trace)
        got = rep.components()
        worst = max(abs(got[k] - v) / max(abs(v), abs(got[k]), 1e-300)
                    for k, v in want["sim"].items())
        ok = worst <= 1e-9 and rep.counters() == want["counters"]
        if outage:
            ok = ok and rep.availability() == want["availability"]
        out.append({"fixture": path.stem, "max_rel_delta": worst, "ok": ok})
    return out


# -- the flash-attention kernels ---------------------------------------------

#: (B, Hq, Hkv, Sq, Skv, D, causal, q_offset, dtype): the six cases of
#: tests/test_kernels.py::test_flash_attention_vs_oracle, then the serving
#: path's prefill and decode shapes (llama3.2-1b, batch 4, 1024-token prompt,
#: a decode step late in a 1056-slot cache), all on the planned route.
FLASH_CASES = [
    (2, 4, 2, 256, 256, 64, True, 0, "float32"),
    (1, 2, 2, 128, 384, 128, False, 0, "float32"),
    (1, 4, 1, 1, 512, 64, True, 511, "float32"),
    (2, 2, 2, 200, 200, 80, True, 0, "float32"),
    (1, 8, 4, 130, 257, 96, True, 0, "float32"),
    (2, 4, 4, 256, 256, 64, True, 0, "bfloat16"),
]
FLASH_PREFILL = (4, 32, 8, 1024, 1024, 64, True, 0, "bfloat16")
FLASH_DECODE = (4, 32, 8, 1, 1056, 64, True, 1040, "bfloat16")
#: A decode step against an 8,192-key cache: 67.1 MB of K/V.
FLASH_DECODE_8K = (4, 32, 8, 1, 8192, 64, True, 8191, "bfloat16")
#: The f32 gate's attention call (B 1, S 256): the simt route's main path.
FLASH_F32 = (1, 32, 8, 256, 256, 64, True, 0, "float32")
#: Each bf16 route forced on cases of its own: group 7 at D 128
#: (qwen2-vl-7b 28/4, deepseek-coder-33b 56/8), a chunk at an offset,
#: the 8,192-key decode, and bf16 on the simt route.
FLASH_ROUTE_CASES = [
    ((2, 28, 4, 333, 333, 128, True, 0, "bfloat16"), "wgmma"),
    ((1, 56, 8, 200, 200, 128, True, 0, "bfloat16"), "wgmma"),
    ((1, 8, 2, 100, 356, 64, True, 256, "bfloat16"), "wgmma"),
    ((2, 28, 4, 1, 1056, 128, True, 1000, "bfloat16"), "splitkv"),
    (FLASH_DECODE_8K, "splitkv"),
    ((1, 8, 2, 16, 200, 64, True, 150, "bfloat16"), "splitkv"),
    ((2, 2, 2, 200, 200, 80, True, 0, "bfloat16"), "simt"),
    (FLASH_PREFILL, "simt"),
    (FLASH_DECODE, "simt"),
]
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
#: A second limit on the bf16 routes, beside the reference's: each output
#: row's (a position's and head's) largest error at most this share of the
#: row's largest |value|, 4 to 8 bf16 ulps of it.  A decode step's outputs
#: average over thousands of keys and are about as small as the reference's
#: 2e-2 (typically ~0.02 at 8,192 keys), so that tolerance alone cannot see
#: a split or a key left out there.  flash_controls shows that this does.
BF16_TIGHT = 2.0 ** -5
#: Device kernels of each route, as the profiler names them.
ROUTE_KERNELS = {"wgmma": ("flash_prefill_kernel",),
                 "splitkv": ("flash_decode_split_kernel",
                             "flash_decode_merge_kernel"),
                 "simt": ("flash_kernel",)}
ROUTE_SOURCES = {
    "simt": "src/repro_torch/kernels/csrc/flash_attention.cu",
    "wgmma": "src/repro_torch/kernels/csrc/flash_prefill_sm90.cu",
    "splitkv": "src/repro_torch/kernels/csrc/flash_decode_splitkv.cu"}
SDPA_NOTE = ("torch.nn.functional.scaled_dot_product_attention (enable_gqa), "
             "timed as a yardstick only")


def flash_inputs(case, dev):
    import numpy as np
    import torch

    b, hq, hkv, sq, skv, d, _causal, _off, dtype = case
    rng = np.random.default_rng(b * 31 + sq + skv)
    shapes = ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d))
    return [torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
            .to(dev, getattr(torch, dtype)) for sh in shapes]


def flash_bound_ms(case) -> tuple:
    """Least time for one call on these inputs: Q and O once, the K/V rows
    some query attends once, over the HBM rate; against 4 * D operations per
    attended (query, key) pair (two products) over the peak rate of the
    inputs' type."""
    b, hq, hkv, sq, skv, d, causal, off, dtype = case
    if causal:
        pairs = sum(max(0, min(skv, off + i + 1)) for i in range(sq))
        kv_rows = max(0, min(skv, off + sq))
    else:
        pairs, kv_rows = sq * skv, skv
    item = 2 if dtype == "bfloat16" else 4
    n_bytes = item * (2 * b * hq * sq * d + 2 * b * hkv * kv_rows * d)
    rate = BF16_OPS_PER_S if dtype == "bfloat16" else F32_OPS_PER_S
    ops_s = 4 * b * hq * pairs * d / rate
    bytes_s = n_bytes / HBM_BYTES_PER_S
    return (1e3 * max(bytes_s, ops_s),
            "bytes" if bytes_s >= ops_s else "operations")


def sdpa_call(case, q, k, v):
    """The library yardstick: one scaled_dot_product_attention call on the
    same inputs ([B, H, S, D], GQA in the call).  A decode step at q_offset
    attends keys 0..q_offset, which is SDPA without a mask over those keys."""
    import torch.nn.functional as F

    causal, off, sq = case[6], case[7], case[3]
    if causal and off:
        if sq != 1:
            raise ValueError("only decode steps carry a q_offset here")
        k, v = k[:, :, :off + 1], v[:, :, :off + 1]
        causal = False
    return lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                                  enable_gqa=True)


def cuda_ms_cold(fn, reps: int = 30) -> float:
    """Median time of one call with the 50 MB L2 flushed before it (a
    128 MB fill), as the serve loop finds each layer's K/V: CUDA events
    around the call alone."""
    import torch

    flush = torch.empty(32 << 20, dtype=torch.float32, device="cuda")
    fn()
    per = []
    for _ in range(reps):
        flush.fill_(1.0)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        per.append(a.elapsed_time(b))
    del flush
    return statistics.median(per)


def route_device_us(prof: dict, route: str):
    """Mean device microseconds of one call of a route: the sum over its
    kernels of each kernel's mean (splitkv: split + merge)."""
    total, seen = 0.0, False
    for name in ROUTE_KERNELS[route]:
        us = kernel_device_us(prof, name)
        if us is not None:
            total, seen = total + us, True
    return total if seen else None


def flash_compare(got, want, dtype: str) -> dict:
    """``got`` against the plain version's ``want``: within the reference's
    tolerance everywhere, and for bf16 each row within :data:`BF16_TIGHT`
    of the row's largest |want|."""
    import torch

    tol = FLASH_TOL[dtype]
    err = (got.float() - want.float()).abs()
    excess = float((err - (tol + tol * want.float().abs())).max())
    row_max = want.float().abs().amax(dim=-1, keepdim=True)
    rel = float((err / row_max.clamp_min(1e-30)).max())
    ok = (bool(torch.isfinite(got).all()) and excess <= 0.0
          and (dtype != "bfloat16" or rel <= BF16_TIGHT))
    return {"max_abs_err": float(err.max()), "max_excess_over_tol": excess,
            "max_err_over_row_max": rel, "ok": ok}


def _bshd(x):
    return x.transpose(1, 2)


def flash_launch(route, q, k, v, causal, off):
    """``route`` forced on ``[B, S, H, D]`` inputs, with the planner's
    splits (the ``splitkv`` route plans itself on every call it takes)."""
    from repro_torch.kernels import flash_attention as fa

    return fa._launch(route, q, k, v, causal, off,
                      fa.plan(q, k, causal, off)[1])


def flash_check(case, dev, route=None) -> dict:
    """One call on ``route`` (planned if None) against the plain version, in
    the [B, H, S, D] layout of ``ops.flash_attention`` (strided views of the
    kernels' [B, S, H, D])."""
    import torch
    from repro_torch.kernels import flash_attention as fa

    causal, off, dtype = case[6], case[7], case[8]
    q, k, v = (_bshd(x) for x in flash_inputs(case, dev))
    planned = fa.plan(q, k, causal, off)[0]
    if route is None:
        got = fa.flash_attention_bshd(q, k, v, causal=causal, q_offset=off)
    else:
        got = flash_launch(route, q, k, v, causal, off)
    want = fa.plain(q, k, v, causal, off)
    torch.cuda.synchronize()
    return {"case": list(case), "route": route or planned,
            "planned_route": planned, **flash_compare(got, want, dtype)}


def flash_controls(dev) -> list:
    """Defects the comparison must catch.  Each route runs with the keys
    that a defect would leave out cut from its inputs, and is held against
    the plain version of the whole call.  The phase fails if the comparison
    passes one of them."""
    import torch
    from repro_torch.kernels import flash_attention as fa

    def last_split(case):
        n_live = fa.live_keys(case[3], case[4], case[6], case[7])
        b, _hq, hkv = case[:3]
        return fa.split_ranges(n_live, fa.decode_splits(b * hkv, n_live))[-1]

    todo = [
        ("splitkv", FLASH_DECODE, "the last live key left out (mask off by "
         "one)", FLASH_DECODE[7]),
        ("splitkv", FLASH_DECODE_8K, "the last split left out",
         last_split(FLASH_DECODE_8K)[0]),
        ("wgmma", FLASH_PREFILL, "the last 64-key tile left out",
         FLASH_PREFILL[4] - 64),
    ]
    out = []
    for route, case, defect, n_keys in todo:
        causal, off = case[6], case[7]
        q, k, v = (_bshd(x) for x in flash_inputs(case, dev))
        got = flash_launch(route, q, k[:, :n_keys], v[:, :n_keys], causal, off)
        want = fa.plain(q, k, v, causal, off)
        torch.cuda.synchronize()
        row = flash_compare(got, want, case[8])
        tol = FLASH_TOL[case[8]]
        out.append({"route": route, "case": list(case), "defect": defect,
                    "keys": n_keys, **row,
                    "caught_by_reference_tol": row["max_excess_over_tol"] > 0,
                    "caught": not row["ok"], "tol": tol})
    return out


def flash_timing(case, dev, route: str, n_per: int, cold: bool = False,
                 library: bool = True) -> dict:
    """A route's time on one case: CUDA events over back-to-back calls (warm
    L2), the profiler's device time, optionally with L2 flushed, beside the
    plain version's, SDPA's and the bound."""
    import torch
    from repro_torch.kernels import flash_attention as fa

    causal, off = case[6], case[7]
    q, k, v = flash_inputs(case, dev)
    qs, ks, vs = _bshd(q), _bshd(k), _bshd(v)

    splits = fa.plan(qs, ks, causal, off)[1]

    def call():
        return fa._launch(route, qs, ks, vs, causal, off, splits)

    ms = cuda_ms(call, n_per)
    prof = device_profile(lambda: [call() for _ in range(n_per)])
    bound_ms, bound_by = flash_bound_ms(case)
    row = {"case": list(case), "route": route, "ms": ms,
           "device_us": route_device_us(prof, route),
           "plain_ms": cuda_ms(lambda: fa.plain(qs, ks, vs, causal, off), 3),
           "library_ms": (cuda_ms(sdpa_call(case, q, k, v), n_per)
                          if library else None),
           "bound_ms": bound_ms, "bound_by": bound_by,
           "share_of_bound": bound_ms / ms}
    if row["device_us"]:
        row["device_share_of_bound"] = bound_ms / (1e-3 * row["device_us"])
    if cold:
        row["cold_ms"] = cuda_ms_cold(call)
        row["library_cold_ms"] = cuda_ms_cold(sdpa_call(case, q, k, v))
    del q, k, v, qs, ks, vs
    torch.cuda.empty_cache()
    return row


def phase_flash(dev) -> dict:
    import torch
    from repro_torch.kernels import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    checks = []
    todo = ([(c, None) for c in FLASH_CASES + [FLASH_PREFILL, FLASH_DECODE]]
            + FLASH_ROUTE_CASES)
    for case, route in todo:
        checks.append(flash_check(case, dev, route))
        if not checks[-1]["ok"]:
            emit("flash", ok=False, checks=checks)
            raise SystemExit(f"flash attention ({checks[-1]['route']} route) "
                             f"disagrees with its plain version at {case}")
    max_abs = {r: max([c["max_abs_err"] for c in checks if c["route"] == r],
                      default=None) for r in fa.ROUTES}
    controls = flash_controls(dev)
    if not all(c["caught"] for c in controls):
        emit("flash", ok=False, checks=checks, controls=controls)
        raise SystemExit("the flash comparison passes a deliberate defect: "
                         + "; ".join(c["defect"] for c in controls
                                     if not c["caught"]))

    timings = {
        "wgmma_prefill": flash_timing(FLASH_PREFILL, dev, "wgmma", 20),
        "splitkv_decode": flash_timing(FLASH_DECODE, dev, "splitkv", 200,
                                       cold=True),
        "splitkv_decode_8k": flash_timing(FLASH_DECODE_8K, dev, "splitkv",
                                          100, cold=True),
        "simt_f32": flash_timing(FLASH_F32, dev, "simt", 50),
        # The CUDA-core kernel at the bf16 serving shapes, in the same run.
        "simt_prefill_bf16": flash_timing(FLASH_PREFILL, dev, "simt", 20,
                                          library=False),
        "simt_decode_bf16": flash_timing(FLASH_DECODE, dev, "simt", 200,
                                         cold=True, library=False),
    }
    emit("flash", ok=True, routes=list(fa.ROUTES), tol=FLASH_TOL,
         tight=BF16_TIGHT, checks=checks, controls=controls, timings=timings,
         build_logs={r: lib.log[-2000:] for r, lib in fa.LIBRARIES.items()})
    return {"max_abs_err": max_abs, "timings": timings}


# -- the serving path ----------------------------------------------------------

SERVE_ARGS = ["--arch", "llama3.2-1b", "--no-reduced", "--requests", "6",
              "--batch", "4", "--prompt-len", "1024", "--gen", "32",
              "--seed", "0", "--device", "cuda"]
GATE_LEN = 256
GATE_REL = 1e-3
#: The bf16 logits check holds the kernels' bf16 path to the plain
#: attention's bf16 path by their accuracy against the f32 logits of the
#: same weights: the kernel path's max and mean absolute errors may exceed
#: the plain path's by at most these factors.  Two bf16 paths round in
#: different places (q pre-scaled in bf16, p in bf16 before or after
#: normalising, exp2), so they differ from each other by about as much as
#: each differs from f32.  The bf16 projections and MLP set most of that
#: error, so the logits can hide a small attention defect: the check also
#: holds the first layer's attention output, on the activations the model
#: gave it, to the plain version within BF16_TIGHT of each row's largest
#: value, and a control (the last 64-key tile left out of every layer's
#: call) must fail it.  The reference's elementwise 2e-2 does not apply
#: there: it is set for unit-scale inputs, and layer 0's rows reach ~17,
#: where one bf16 ulp is 0.125.
BF16_MAX_FACTOR = 1.5
BF16_MEAN_FACTOR = 1.25


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def phase_serve(dev) -> dict:
    import dataclasses

    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ttl_scan
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import forward, layers
    from repro_torch.serve import prefill

    torch.backends.cuda.matmul.allow_tf32 = False
    args = launch_serve.build_parser().parse_args(SERVE_ARGS)
    torch.cuda.reset_peak_memory_stats(dev)
    fa.reset_launches()
    ttl_scan.ttl_cost_surface.launches = 0
    t0 = time.perf_counter()
    res = launch_serve.run(args)
    wall = time.perf_counter() - t0
    launches = fa.flash_attention_bshd.launches
    route_launches = dict(fa.flash_attention_bshd.route_launches)
    ttl_launches = ttl_scan.ttl_cost_surface.launches
    peak = torch.cuda.max_memory_allocated(dev)
    cfg, params, tier = res["cfg"], res["params"], res["tier"]
    tier_stats = json.loads(json.dumps(tier.stats))     # before the traced run

    prefills = res["hit"].count(False)
    steps = sum(res["decode_steps"])
    want_launches = cfg.n_layers * (prefills + steps)
    want_routes = {"wgmma": cfg.n_layers * prefills,
                   "splitkv": cfg.n_layers * steps, "simt": 0}
    tokens = torch.stack(res["tokens"])
    tokens_ok = (tuple(tokens.shape) == (args.requests, args.batch, args.gen)
                 and bool(((tokens >= 0) & (tokens < cfg.vocab)).all()))
    prefill_s = [x for x in res["prefill_s"] if x is not None]
    decode_s = sum(res["decode_s"])
    n_tok = args.requests * args.batch * args.gen

    # The tier's caches are the prefill's, untouched by the decodes that ran
    # on clones of them: a fresh prefill of each prompt gives them bit for
    # bit.  (The tier holds the three prompts' blocks in miss order.)
    prompts = launch_serve.make_prompts(cfg, args)
    payload_ok = []
    for prompt, blk in zip(prompts[:3], tier.blocks.values()):
        _lg, fresh, _pos = prefill(cfg, params, prompt.to(dev),
                                   max_len=args.prompt_len + args.gen)
        stored = blk.payload[0]
        payload_ok.append(all(
            torch.equal(stored[g][n][key], fresh[g][n][key])
            for g in fresh for n in fresh[g] for key in fresh[g][n]))
        del fresh
    reuse_agree = float(torch.stack([
        (tokens[i] == tokens[i + 3]).double().mean() for i in range(3)]).mean())

    # Two more requests (hits) traced: where the card's time goes in decode,
    # and where the host's goes.
    def hit_request():
        launch_serve.serve(cfg, params, prompts[:1], args.gen, tier, dev)

    prof = device_profile(hit_request)
    host = host_profile(hit_request)

    # The bf16 check at full width: logits through the kernels (the wgmma
    # route) and through the plain attention, both in bf16; held against the
    # f32 logits below.
    tier.blocks.clear()
    torch.cuda.empty_cache()
    toks = torch.randint(0, cfg.vocab, (1, GATE_LEN),
                         generator=torch.Generator().manual_seed(12)).to(dev)
    kernel_attn = layers.flash_attention_bshd

    def tile_left_out(q, k, v, causal, q_offset):
        return kernel_attn(q, k[:, :-64], v[:, :-64], causal=causal,
                           q_offset=q_offset)

    def bf16_forward(attn):
        """Logits through ``attn`` in every layer, and the first layer's
        attention output held to the plain version on its own inputs."""
        seen = []

        def first_layer(q, k, v, causal, q_offset):
            out = attn(q, k, v, causal=causal, q_offset=q_offset)
            if not seen:
                row = flash_compare(out, fa.plain(q, k, v, causal, q_offset),
                                    "bfloat16")
                # BF16_TIGHT alone: see the note above BF16_MAX_FACTOR.
                row["ok"] = (bool(torch.isfinite(out).all())
                             and row["max_err_over_row_max"] <= BF16_TIGHT)
                seen.append(row)
            return out

        layers.flash_attention_bshd = first_layer
        try:
            with torch.no_grad():
                logits = forward(cfg, params, toks)[0]
        finally:
            layers.flash_attention_bshd = kernel_attn
        return logits, seen[0]

    fa.reset_launches()
    lk16, layer0 = bf16_forward(kernel_attn)
    bf16_routes = dict(fa.flash_attention_bshd.route_launches)
    lc16, layer0_control = bf16_forward(tile_left_out)
    with torch.no_grad():
        lp16, _, _ = forward(cfg, params, toks, plain_attention=True)
    torch.cuda.synchronize()

    # The f32 gate at full width: logits through the kernel (the simt
    # route) against logits through the plain attention, same parameters
    # (bf16 -> f32 is exact).
    cfg32 = dataclasses.replace(cfg, act_dtype="float32",
                                param_dtype="float32")
    p32 = _tree_map(lambda t: t.float(), params)
    del params, res
    torch.cuda.empty_cache()
    fa.reset_launches()
    with torch.no_grad():
        lk, _, _ = forward(cfg32, p32, toks)
        simt_launches = fa.flash_attention_bshd.route_launches["simt"]
        lp, _, _ = forward(cfg32, p32, toks, plain_attention=True)
    torch.cuda.synchronize()
    diff = float((lk - lp).abs().max())
    scale = float(lp.abs().max())
    gate_ok = (bool(torch.isfinite(lk).all()) and diff <= GATE_REL * scale
               and simt_launches == cfg.n_layers)
    gate = {"batch": 1, "seq": GATE_LEN, "simt_launches": simt_launches,
            "max_abs_diff": diff,
            "max_abs_logit": scale, "limit": GATE_REL * scale,
            "argmax_agreement":
                float((lk.argmax(-1) == lp.argmax(-1)).double().mean()),
            "ok": gate_ok}

    # The bf16 check, against the f32 plain logits lp.
    def vs_f32(logits):
        err = (logits.float() - lp).abs()
        return {"max_abs": float(err.max()), "mean_abs": float(err.mean())}

    e_k, e_p, e_c = vs_f32(lk16), vs_f32(lp16), vs_f32(lc16)
    limits = {"max_abs": BF16_MAX_FACTOR * e_p["max_abs"],
              "mean_abs": BF16_MEAN_FACTOR * e_p["mean_abs"]}

    def within(e):
        return all(e[key] <= limits[key] for key in limits)

    control_caught = not (bool(torch.isfinite(lc16).all()) and within(e_c)
                          and layer0_control["ok"])
    bf16_ok = (bool(torch.isfinite(lk16).all()) and within(e_k)
               and layer0["ok"] and control_caught
               and bf16_routes["wgmma"] == cfg.n_layers)
    bf16_check = {
        "batch": 1, "seq": GATE_LEN, "route_launches": bf16_routes,
        "kernel_vs_f32": e_k, "plain_vs_f32": e_p, "limits": limits,
        "layer0_attention": layer0,
        "control": {"defect": "the last 64-key tile left out of every "
                              "layer's attention call",
                    "vs_f32": e_c,
                    "caught_by_logits": not within(e_c),
                    "layer0_attention": layer0_control,
                    "caught": control_caught},
        "kernel_vs_plain_max_abs": float((lk16.float() - lp16.float())
                                         .abs().max()),
        "argmax_agreement_kernel_plain":
            float((lk16.argmax(-1) == lp16.argmax(-1)).double().mean()),
        "argmax_agreement_kernel_f32":
            float((lk16.argmax(-1) == lp.argmax(-1)).double().mean()),
        "argmax_agreement_plain_f32":
            float((lp16.argmax(-1) == lp.argmax(-1)).double().mean()),
        "ok": bf16_ok}
    del p32, lk, lp, lk16, lp16, lc16
    torch.cuda.empty_cache()

    ok = (launches == want_launches and route_launches == want_routes
          and prefills == 3 and tokens_ok and all(payload_ok) and gate_ok
          and bf16_ok)
    emit("serve", ok=ok, args=SERVE_ARGS, layers=cfg.n_layers,
         d_model=cfg.d_model, heads=[cfg.n_heads, cfg.n_kv_heads],
         vocab=cfg.vocab, prefills=prefills, decode_steps=steps,
         flash_launches=launches, flash_launches_expected=want_launches,
         route_launches=route_launches, route_launches_expected=want_routes,
         ttl_scan_launches=ttl_launches,
         prefill_ms=[1e3 * x for x in prefill_s],
         decode_ms_per_step=1e3 * decode_s / steps,
         tokens_per_s=n_tok / (sum(prefill_s) + decode_s), wall_s=wall,
         peak_memory_bytes=peak, tier_stats=tier_stats,
         tokens_ok=tokens_ok, tier_payload_unchanged=payload_ok,
         reused_prefix_token_agreement=reuse_agree,
         traced_hit_request=prof, host_profile_hit_request=host,
         bf16_check=bf16_check, f32_gate=gate)
    if not ok:
        raise SystemExit("serving path check failed")
    return {"routes": route_launches, "simt_gate": simt_launches,
            "ttl_launches": ttl_launches}

def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: no port sources under {SRC}; run it from the root "
              "of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import flash_attention, ttl_scan
    from repro_torch.kernels.ops import resolve_device

    dev = resolve_device("cuda")
    smi = nvidia_smi()
    t0 = time.perf_counter()
    libraries = (ttl_scan.LIBRARY, *flash_attention.LIBRARIES.values())
    for lib in libraries:            # one nvcc per source, all at once
        lib.start()
    for lib in libraries:
        lib.load()
    emit("device", ok=True, nvidia_smi=smi,
         name=torch.cuda.get_device_name(0),
         capability=list(torch.cuda.get_device_capability(0)),
         torch=torch.__version__, cuda=torch.version.cuda,
         build_s=time.perf_counter() - t0,
         nvcc_s={lib.name: lib.seconds for lib in libraries})

    kern = phase_kernels(dev)
    phase_decisions(dev)
    launches = phase_replay(dev)
    flash = phase_flash(dev)
    serve = phase_serve(dev)

    main_t, scale_t = kern["timings"]
    t = flash["timings"]

    def flash_entry(name, route, row, launches, **extra):
        return {"name": name, "route": "cuda", "source": ROUTE_SOURCES[route],
                "replaces": "src/repro/kernels/flash_attention.py:44",
                "launches": launches,
                "max_abs_err": flash["max_abs_err"][route],
                **{k: row[k] for k in ("ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms")},
                "library_note": SDPA_NOTE, "flash_route": route,
                "shape": row["case"], "device_us": row["device_us"], **extra}

    summary = {"kernels": [{
        "name": "ttl_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ttl_scan.cu",
        "replaces": "src/repro/kernels/ttl_scan.py:56",
        "launches": launches, "max_abs_err": kern["max_abs_err"],
        **{k: main_t["decision"][k] for k in ("ms", "plain_ms", "bound_ms",
                                              "bound_by", "device_us")},
        "library_ms": None, "library_note": LIBRARY_NOTE,
        "shape": [E_MAIN, C_MAIN],
        "call": "decision, one shared histogram row, no surface (a "
                "controller refresh)",
        "surface_call": main_t["surface"],
        "refresh_us_host": {k: main_t[k] for k in
                            ("refresh_us_host", "refresh_us_host_shared")},
        "at_scale": {"E": E_SCALE, "C": C_MAIN, "surface": scale_t["surface"],
                     "decision": scale_t["decision"]},
        "serve_launches": serve["ttl_launches"],
    },
        flash_entry("flash_attention_wgmma", "wgmma", t["wgmma_prefill"],
                    serve["routes"]["wgmma"]),
        flash_entry("flash_attention_splitkv", "splitkv", t["splitkv_decode"],
                    serve["routes"]["splitkv"],
                    decode_8k={k: t["splitkv_decode_8k"][k] for k in
                               ("case", "ms", "device_us", "bound_ms",
                                "library_ms")}),
        flash_entry("flash_attention", "simt", t["simt_f32"],
                    serve["simt_gate"],
                    launches_note="the f32 gate's forward; the bf16 serve "
                                  "run sends it none",
                    bf16_serving_shapes={k: {f: t[k][f] for f in ("ms", "device_us")}
                                 for k in ("simt_prefill_bf16",
                                           "simt_decode_bf16")}),
    ]}
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(json.dumps({**RESULT, "summary": summary}, indent=1))
    print(json.dumps(summary))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
