#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA H100 and check it.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds every kernel of the path from the sources in ``src/repro_torch``
(nvcc, sm_90a), then runs four phases, printing one JSON line each and
stopping with a non-zero exit at the first that fails:

  device     the card's name and power limit (nvidia-smi) and the build time;
  kernels    each kernel against its plain PyTorch version on the card (the
             CPU-test sweep shapes and the §6.7.3 scale, rtol 2e-5 / atol
             1e-4), its time by CUDA events beside the plain version's and
             the bound, and how often its TTL index equals the float64 one;
  decisions  on a replay-harvested histogram corpus, every edge TTL from the
             kernel engine equals the scalar python engine's;
  replay     the main path: a large-tier 9-region zipfian trace replayed
             with SkyStore on the kernel engine (card) and on the float64
             torch engine (CPU) -- identical decisions, dollars and counters
             -- and the golden replay fixtures of the SkyStore policy
             reproduced with the kernel engine.

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

#: Card peaks used for the bound (NVIDIA H100 SXM data sheet): HBM3 rate and
#: the float32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

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

def ttl_scan_bound_ms(e_dim: int, c_dim: int) -> tuple:
    """Least time for one surface: each input read once and the output
    written once over the HBM rate, against the float32 operations over the
    card's float32 peak.  Per cell: 24 operations (midpoint 2, t_hat 1, two
    products, six prefix-sum adds with the row totals, 13 in the cost
    expression)."""
    n_bytes = 4 * (4 * e_dim * c_dim + c_dim + 3 * e_dim)
    ops_s = 24 * e_dim * c_dim / F32_OPS_PER_S
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


def kernel_device_us(prof: dict):
    """Mean device microseconds of the TTL-scan kernel in a profile."""
    for name, op in prof.get("ops", {}).items():
        if "ttl_scan_kernel" in name:
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
    """Canonical-argmin TTL indices of the kernel surface (with the TTL=0
    column), as the controller takes them."""
    import torch
    from repro_torch.kernels.ops import _canonical_argmin
    from repro_torch.kernels.ttl_scan import ttl_cost_surface

    t = [torch.as_tensor(x, device=dev).contiguous() for x in prob]
    hist, time_w, last, edges, s, n, first = t
    surf = ttl_cost_surface(*t)
    zero = (first + hist.sum(dim=1)) * n
    return _canonical_argmin(torch.cat([zero[:, None], surf], dim=1))


def phase_kernels(dev) -> dict:
    import torch
    from repro_torch.kernels import ref, ttl_scan
    from repro_torch.kernels.ops import ttl_scan_from_histograms
    from repro_torch.core.costmodel import pick_regions
    from repro_torch.core.histogram import AccessHistogram

    def on_card(prob):
        return [torch.as_tensor(x, device=dev).contiguous() for x in prob]

    # Numerics against the plain version, on the card.
    checks, max_abs = [], 0.0
    probs = [(e, c, problem(e, c, seed=e * 1000 + c)) for e, c in SWEEP]
    probs += [(e, C_MAIN, problem(e, C_MAIN, seed=0)) for e in (E_MAIN, E_SCALE)]
    for e_dim, c_dim, prob in probs:
        t = on_card(prob)
        k = ttl_scan.ttl_cost_surface(*t)
        p = ref.ttl_cost_ref(*t)
        torch.cuda.synchronize()
        err = (k - p).abs()
        excess = float((err - (ATOL + RTOL * p.abs())).max())
        ok = bool(torch.isfinite(k).all()) and excess <= 0.0
        checks.append({"E": e_dim, "C": c_dim, "max_abs_err": float(err.max()),
                       "max_excess_over_tol": excess, "ok": ok})
        max_abs = max(max_abs, float(err.max()))
        if not ok:
            emit("kernels", ok=False, checks=checks)
            raise SystemExit(f"ttl_scan disagrees with its plain version at "
                             f"E={e_dim} C={c_dim}")

    # Times, bounds and TTL-index agreement at the main-path and the
    # §6.7.3 shapes.
    timings = []
    for e_dim in (E_MAIN, E_SCALE):
        prob = problem(e_dim, C_MAIN, seed=0)
        t = on_card(prob)
        n_per = 200 if e_dim == E_MAIN else 5
        ms = cuda_ms(lambda: ttl_scan.ttl_cost_surface(*t), n_per)
        plain_ms = cuda_ms(lambda: ref.ttl_cost_ref(*t), n_per)
        # Device time per launch, apart from the host's issue rate that
        # back-to-back CUDA-event timing includes at small E.
        prof = device_profile(
            lambda: [ttl_scan.ttl_cost_surface(*t) for _ in range(n_per)])
        bound_ms, bound_by = ttl_scan_bound_ms(e_dim, C_MAIN)
        share = float((kernel_indices(prob, dev) == f64_indices(prob))
                      .double().mean())
        # One whole refresh as the controller runs it: E histograms in
        # float64 on the host -> float32 on the card -> kernel -> float64
        # surface back -> canonical argmin.  Host clock.
        cat = pick_regions(9)
        pairs = [(a, b) for a in cat.region_names()
                 for b in cat.region_names() if a != b]
        targets = [pairs[i % len(pairs)] for i in range(e_dim)]
        edges64 = torch.from_numpy(prob[3].astype("float64"))
        h64 = [torch.from_numpy(x.astype("float64")) for x in prob[:3]]
        hists = [AccessHistogram(edges64, h64[0][i], h64[1][i], h64[2][i],
                                 float(prob[6][i]), 1) for i in range(e_dim)]
        reps = 50 if e_dim == E_MAIN else 3
        ttl_scan_from_histograms(hists, cat, targets, device=dev)
        walls = []
        for _ in range(reps):
            t0 = time.perf_counter()
            ttl_scan_from_histograms(hists, cat, targets, device=dev)
            walls.append(time.perf_counter() - t0)
        timings.append({
            "E": e_dim, "C": C_MAIN, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "share_of_bound": bound_ms / ms, "ttl_index_agreement": share,
            "kernel_device_us": kernel_device_us(prof),
            "refresh_us_host": 1e6 * statistics.median(walls)})
        del t
        torch.cuda.empty_cache()
    emit("kernels", ok=True, ported=["ttl_scan"], rtol=RTOL, atol=ATOL,
         checks=checks, timings=timings, build_log=ttl_scan._Build.log[-2000:],
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

    def replay(engine, device):
        policy = make_policy("skystore", cat, engine=engine, device=device)
        sim = Simulator(cat, policy, mode="FB", track_decisions=True)
        t0 = time.perf_counter()
        report = sim.run(trace)
        secs = time.perf_counter() - t0
        return report, sim.decisions, secs, policy.ctl.n_refreshes

    ttl_scan.ttl_cost_surface.launches = 0
    rep_k, dec_k, secs_k, refreshes = replay("kernel", dev)
    launches = ttl_scan.ttl_cost_surface.launches
    rep_t, dec_t, secs_t, _ = replay("torch", "cpu")
    # A third, traced run of the kernel engine: where the card's time goes
    # and how long it idles (the two runs above are untraced).
    prof = device_profile(lambda: replay("kernel", dev))
    n_ev = len(trace.events)
    same = (dec_k == dec_t, rep_k.components() == rep_t.components(),
            rep_k.counters() == rep_t.counters())
    golden = golden_skystore(dev)
    ok = all(same) and launches > 0 and all(g["ok"] for g in golden)
    emit("replay", ok=ok, events=n_ev, gets=rep_k.n_get,
         decisions_identical=same[0], components_identical=same[1],
         counters_identical=same[2], refreshes=refreshes,
         kernel_launches=launches,
         events_per_s={"kernel_cuda": n_ev / secs_k, "torch_cpu": n_ev / secs_t},
         components=rep_k.components(), counters=rep_k.counters(),
         traced_kernel_replay=prof, golden=golden)
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
    from repro_torch.kernels import ttl_scan
    from repro_torch.kernels.ops import resolve_device

    dev = resolve_device("cuda")
    smi = nvidia_smi()
    t0 = time.perf_counter()
    ttl_scan.library()
    emit("device", ok=True, nvidia_smi=smi,
         name=torch.cuda.get_device_name(0),
         capability=list(torch.cuda.get_device_capability(0)),
         torch=torch.__version__, cuda=torch.version.cuda,
         build_s=time.perf_counter() - t0, nvcc_s=ttl_scan._Build.seconds)

    kern = phase_kernels(dev)
    phase_decisions(dev)
    launches = phase_replay(dev)

    main_t = kern["timings"][0]
    summary = {"kernels": [{
        "name": "ttl_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ttl_scan.cu",
        "replaces": "src/repro/kernels/ttl_scan.py:56",
        "launches": launches, "max_abs_err": kern["max_abs_err"],
        "ms": main_t["ms"], "plain_ms": main_t["plain_ms"],
        "bound_ms": main_t["bound_ms"], "bound_by": main_t["bound_by"],
        "library_ms": None, "library_note": LIBRARY_NOTE,
        "shape": [E_MAIN, C_MAIN],
        "at_scale": {k: kern["timings"][1][k] for k in
                     ("E", "C", "ms", "plain_ms", "bound_ms", "bound_by")},
    }]}
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(json.dumps({**RESULT, **summary}, indent=1))
    print(json.dumps(summary))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
