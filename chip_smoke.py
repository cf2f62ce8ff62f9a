#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA H100 and check it.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds every kernel of the paths from the sources in ``src/repro_torch``
(one nvcc per source for sm_90a, all started together), then runs sixteen
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
  live       the live plane: the same trace through ``replay_differential``
             (simulator and live VirtualStore -> MetadataServer -> CostLedger)
             with both planes' controllers on the card -- zero divergence,
             latency streams identical, decisions, dollars, counters and
             refreshes equal to the same differential on the torch CPU
             engine, TTL-scan launches equal to the refreshes, a traced
             live replay with no other device op; SkyStore's 8 golden
             fixtures through the port's differential on the kernel engine
             and a control that ``check_golden`` must report; and the S3
             proxy on 127.0.0.1 (three client regions) over a store on the
             card, a seeded stream of S3 requests on a virtual clock, every
             status, body digest and ETag equal to a CPU store driven by
             direct ``dispatch``, with at least one refresh;
  flash      the three flash-attention routes against the plain version on
             the card (f32 2e-5, bf16 2e-2): the six CPU-test cases and the
             serving prefill and decode shapes on the planned route, then
             each bf16 route forced on its own cases (group 7 at D 128 in
             prefill and decode, an 8,192-key decode, D 80 / 96 on the
             padded wgmma tile, causal or not, hubert-xlarge's call at
             S 1000); controls that leave keys out of each route; and each
             route's time by CUDA events and by the profiler at its
             main-path shapes (wgmma: serving prefill and hubert-xlarge's
             call at S 1024 and 1000; splitkv: serving decode, warm and with
             L2 flushed, and the 8,192-key decode; simt: the f32 gate's
             shape; both bf16 routes at qwen2-moe-a2.7b's calls too) beside
             the plain version's, the bound and
             scaled_dot_product_attention's; and head dims 192 and 256 with
             the sliding window and the key count: gemma3-4b's windowed
             prefill (S 2,048, window 1,024), its ring decodes (full and
             filling) and a global layer's decode below Skv, nemotron-4-340b's
             prefill and decode (group 12 at D 192), deepseek's MLA prefill
             (D 192), each on its planned route and each route forced at
             D 192 / 256 (simt in f32), three more controls (the window's
             first 64 keys, the last 64 live keys, a window one key
             narrower in f32), and their times beside the plain version's,
             the bound (the pairs inside the window and below kv_len) and
             SDPA's;
  moe_decode the routed MoE kernel pair (``kernels/moe_decode``) at one
             layer of qwen2-moe-a2.7b, deepseek-v2-lite-16b and
             jamba-v0.1-52b at full width, one decode step of B 4 in bf16
             on router-like routes: y within 2^-7 of the plain version's,
             normwise, at both of the gate / up kernel's column tiles; two
             controls that must land outside it (every expert id shifted by
             one, the shared expert left out); the pair's time by CUDA
             events and each kernel's by the profiler beside the bound of
             the call's own routes (the distinct experts and the shared
             ones read once, at 3.35 TB/s), the plain version's time and
             the capacity path's it replaces;
  mla_decode the MLA decode kernel pair (``kernels/mla_decode``) at
             deepseek-v2-lite-16b's full width (16 heads, R 512, rope 64),
             B 4, bf16, kv_len 16,385 and 16,447 of a 16,448-row cache (the
             ``dsv2lite-longdoc-hits`` cell's first and last decode steps):
             o within 2^-7 of the plain version's largest value, on random
             keys and with the last key read planted; two controls that must
             land outside it (the key count one short, one long, the key it
             drops or adds planted); the pair's time by CUDA events and each
             kernel's by the profiler beside the byte bound, the plain
             version's, the absorbed einsums over every slot (the path it
             replaced) and SDPA's over the decompressed per-head K / V;
  rope_cache GQA decode's rope and K / V cache write in one launch
             (``kernels/rope_cache``) at B 4 and the attention shapes of
             qwen2-moe-a2.7b, llama3.2-1b, gemma3-4b (a ring slot, a global
             layer), nemotron-4-340b and a YaRN table, at positions 0, 2,047
             and 16,446, bf16 and fp32: the rotated q and both caches bit for
             bit against ``layers.rotate`` + ``write_seq`` on the card (the
             count of elements that differ and the largest |difference|
             recorded); two controls that must
             differ (the position one too high, k written one slot late);
             at qwen2-moe's B 4 the kernel's time by CUDA events and by the
             profiler beside its byte bound, and the host us a call of the
             kernel's wrapper and of the ops it replaces;
  serve      the serving path: ``repro_torch.launch.serve`` at full width
             (llama3.2-1b, bf16, seeded random weights; 6 requests of batch
             4, 1024-token prompts, 32 generated tokens, three distinct
             prompts so the KV tier sees three misses and three hits), with
             every bf16 attention call required on a new route (wgmma
             launches = layers x prefills, splitkv launches = layers x decode
             steps, simt none), the rope / cache-write kernel once a layer a
             decode step (none in prefill), the tier's stored caches unchanged by
             decoding, a bf16 check and an f32 gate at full width: logits
             through the kernels against logits through the plain attention;
  train      the training path: ``python -m repro_torch.launch.train`` and
             ``python -m repro_torch.launch.serve`` with their default
             (reduced) arguments exit 0 on the card, and the serve default
             run in this process sends every attention call to ``simt``
             (head dim 8 padded to 64); llama3.2-1b at full width in bf16
             (AdamW, f32 master) trains 8 steps of 4 x 1024 tokens on
             batches read through a ``VirtualStore`` on the card (the last
             batch repeated: the loss must fall), with step ms, tokens/s,
             the model-FLOPs share and peak memory; the eval step goes
             through ``wgmma`` (one launch a layer) and its bf16 loss is no
             further from the f32 plain loss than 1.5x the plain bf16 loss's
             distance (or 1e-3 of it); attention that needs a gradient
             raises on the card; the checkpoint is saved in the train
             region, recovered into a third, the first region killed, and
             recovered again bit-equal, then one more finite step, with
             TTL-scan launches equal to the store controller's refreshes
             (>= 1); and the config cut to 2 layers trains 2 f32 steps on
             the card and on the CPU from the same params and batch: losses
             within 1e-4 relative, each param leaf within 1e-3 of its
             largest |value| (the gradients' agreement recorded);
  encode     hubert-xlarge's eval step at full width (48 layers, d 1280,
             16 heads of 80, not causal, bf16, seeded random weights) on
             B 4 x S 1024 frames from the frontend stub of
             ``launch.train``: 48 wgmma launches a step and no simt, the
             bf16 loss through the kernel no further from the f32 plain loss
             than 1.5x the plain bf16 loss is (or 1e-3 of it), layer 0's
             attention within 2^-5 of each row's largest value of the plain
             version with q x scale rounded to bf16 as the TPU kernel rounds
             it, and a control (the last 64 keys left out) caught; the
             step's ms (median of 10 after 2), frames/s, model-FLOPs share
             and peak memory, and a traced step's device time by kernel and
             idle share; then the train step of the configs whose frontend
             never reads ``embed/w`` (hubert-xlarge at full width and depth,
             qwen2-vl-7b at full width cut to 2 layers; bf16, AdamW with an
             f32 master, B 4 x 1,024 frames, 3 steps): finite losses,
             ``embed/w`` and its state (m, v, the f32 master) after each
             step bit-equal to the optimizer's update of them from a zero
             gradient, step ms and peak memory;
  moe_serve  the MoE serving path: ``repro_torch.launch.serve`` with
             qwen2-moe-a2.7b at full width and depth (24 layers, d 2048, 16
             / 16 heads of 128, 60 routed experts top-4 + 4 shared, bf16,
             seeded weights; the serve phase's requests), wgmma launches =
             layers x prefills, splitkv = layers x decode steps, simt none,
             the routed MoE pair 2 x MoE layers x decode steps (prefill on
             the capacity path), the rope / cache-write kernel once an
             attention layer a decode step (none in prefill);
             the tier's caches bit-equal to fresh prefills, which also count
             each MoE layer's dropped (token, k) pairs at capacity factor
             1.25; a traced hit request; with the routing pinned to an f32
             run's, the bf16 logits through the kernels held to the f32
             logits by mean error and argmax agreement against the plain
             bf16 run's, layer 0's attention within 2^-5 of each row's
             largest value (q rounded as the kernel rounds it), and a
             control (64 keys cut from layer 0's call) caught; the f32 gate
             on simt cut to 2 layers;
  gemma_serve  gemma3-4b through ``repro_torch.launch.serve`` at full width
             and depth (34 layers, d 2560, 8 / 4 heads of 256, a 1,024-key
             window on 29 layers, vocab 262,144, bf16, seeded weights): 6
             requests of B 4 x 2,048-token prompts (the window masks half
             of each local prefill's keys), 32 generated tokens on rings
             that wrap; wgmma launches = layers x prefills, splitkv = layers
             x decode steps, simt none, rope_cache = layers x decode steps; the model's calls recorded (windowed
             prefills, ring and global decodes with their kv_len); the
             tier's caches bit-equal to fresh prefills; a traced hit; bf16
             logits through the kernels no further from the f32 plain run's
             than the plain bf16 run's (max 1.5x, mean 1.25x), layer 0 (a
             local layer, positions past the window) within 2^-5 of each
             row's largest value on q rounded as the kernel rounds it, and a
             control (every window one key narrower) caught;
  mixers     deepseek-v2-lite-16b (its dense layer and 2 MLA / MoE layers;
             MLA prefill on the D 192 wgmma kernel, V zero-padded, held to
             its plain-attention run by layer 0's call and a control),
             jamba-v0.1-52b (one repeat of its 8-layer pattern; attention
             on wgmma / splitkv), rwkv6-3b (32 layers) and nemotron-4-340b
             (2 of 96 layers, D 192, group 12) at full width, weights drawn
             per layer:
             a 1,024-token bf16 prefill and 8 decode steps, finite, the
             launches per route, the MLA decode pair's 2 x MLA layers x
             steps in bf16 and none in prefill or in f32, the rope /
             cache-write kernel's GQA layers x steps in bf16 and in f32 and
             none in prefill (the reduced configs' card runs: GQA layers x
             their 3 decode steps), the first
             layer's caches within 2^-5 of a
             prefill of the whole sequence; in f32 activations on the first
             8 layers each step's logits within 2^-4 of each row's scale of
             a full forward of the extended sequence where both compute the
             same function (drop counts equal, an RWKV6 chunk start); the
             five reduced configs (gemma3-4b's windows and rings among them)
             in f32, card against CPU within 1e-4, MLA on the kernel.
  dist       sharding, the dry-run, the roofline, the pipeline and the
             examples: a one-rank NCCL group and ``make_host_mesh()``; the
             GPipe schedule at one stage (S 1, M 4) on llama3.2-1b at full
             width, B 4 x 1,024, against the sequential train-mode forward
             (bf16 logits within 2^-5 of their largest magnitude, argmax on
             99 % of the tokens, both through wgmma), its loss's backward
             finite and its loss within 2^-7 of the sequential plain run's,
             and both forwards' ms; the dry-run of llama3.2-1b on every
             valid shape, gemma3-4b and qwen2-moe-a2.7b on train_4k and
             decode_32k, hubert-xlarge's and nemotron-4-340b's train_4k,
             nemotron-4-340b's and jamba-v0.1-52b's prefill_32k and
             rwkv6-3b's train_4k on the 16 x 16 fake mesh and
             llama3.2-1b's train_4k on 2 x 16 x 16, on fake CUDA tensors,
             traced on the host's other cores from the start of the run:
             every cell traced within 600 s, its per-card bytes under 80 GB
             and its collective bytes above zero, with its roofline row;
             and every ``examples/torch_*.py`` on the
             card at small arguments, exit 0, the serve and quickstart
             examples' kernel launches counted;

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


# -- the live plane ------------------------------------------------------------

#: The proxy leg: a seeded stream of S3 requests from three client regions
#: against one bucket, the clock moving ~1 h a request on average, long
#: enough for the store's controller to refresh.
PROXY_REQUESTS, PROXY_KEYS, PROXY_SEED = 400, 6, 15
PROXY_STEP_S = 3600.0


class VirtualClock:
    """The clock both proxy-leg stores read (replay never reads the host's)."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def controller_refreshes(run) -> int:
    """Refreshes solved by the controllers of one plane's deciders (its
    policy and, for the live plane, its metadata server)."""
    return sum(d.ctl.n_refreshes for d in run.deciders
               if getattr(d, "ctl", None) is not None)


def timed_differential(trace, cat, device) -> tuple:
    """``replay_differential`` with each plane's host seconds and each
    controller refresh's host seconds recorded by plane."""
    from repro_torch.core import replay
    from repro_torch.core.ttl_policy import AdaptiveTTLController

    secs, walls, plane = {}, {"sim": [], "live": []}, ["sim"]
    runners = {"sim": replay.run_sim_plane, "live": replay.run_live_plane}
    refresh = AdaptiveTTLController._refresh_batched

    def timed_refresh(self, *args):
        t0 = time.perf_counter()
        out = refresh(self, *args)
        walls[plane[0]].append(time.perf_counter() - t0)
        return out

    def timed_runner(name):
        def run(*args, **kw):
            plane[0] = name
            t0 = time.perf_counter()
            out = runners[name](*args, **kw)
            secs[name] = time.perf_counter() - t0
            return out
        return run

    AdaptiveTTLController._refresh_batched = timed_refresh
    replay.run_sim_plane = timed_runner("sim")
    replay.run_live_plane = timed_runner("live")
    try:
        report = replay.replay_differential(
            trace, cat, "skystore", routing="auto", track_latency=True,
            device=device)
    finally:
        AdaptiveTTLController._refresh_batched = refresh
        replay.run_sim_plane = runners["sim"]
        replay.run_live_plane = runners["live"]
    return report, secs, walls


def golden_live(dev) -> tuple:
    """SkyStore's 5 workload and 3 outage golden fixtures through the port's
    differential on the kernel engine (both blocks within 1e-9, counters and
    availability as pinned, zero divergence), then the control: one live
    component moved by 1e-8 must be reported."""
    from repro_torch.core.costmodel import pick_regions
    from repro_torch.core.replay import (
        GOLDEN_OUTAGE_PROFILES, GOLDEN_OUTAGE_WORKLOAD, GOLDEN_SEED,
        GOLDEN_WORKLOADS, check_golden, replay_differential,
    )
    from repro_torch.core.workloads import make_outage_schedule, make_workload

    cat = pick_regions(3)
    golden_dir = str(ROOT / "tests" / "golden" / "replay")
    reports = []
    for wl in GOLDEN_WORKLOADS:
        trace = make_workload(wl, cat.region_names(), seed=GOLDEN_SEED)
        reports.append(replay_differential(trace, cat, "skystore", workload=wl,
                                           engine="kernel", device=dev))
    trace = make_workload(GOLDEN_OUTAGE_WORKLOAD, cat.region_names(),
                          seed=GOLDEN_SEED)
    for prof in GOLDEN_OUTAGE_PROFILES:
        sched = make_outage_schedule(prof, cat.region_names(), trace.duration,
                                     seed=GOLDEN_SEED)
        reports.append(replay_differential(
            trace, cat, "skystore", workload=GOLDEN_OUTAGE_WORKLOAD,
            outages=sched, outage=prof, engine="kernel", device=dev))
    rows = [{"fixture": f"{r.workload}@{r.outage}" if r.outage else r.workload,
             "problems": check_golden([r], golden_dir),
             "refreshes": sum(controller_refreshes(p) for p in r.planes)}
            for r in reports]
    for row in rows:
        row["ok"] = not row["problems"] and row["refreshes"] > 0
    bad = reports[0]
    moved = dict(bad.live_costs, storage=bad.live_costs["storage"] * (1 + 1e-8))
    caught = check_golden([type(bad)(**{**bad.__dict__, "live_costs": moved})],
                          golden_dir)
    control = {"what": "live storage of zipfian/skystore x (1 + 1e-8)",
               "problems": caught, "caught": len(caught) == 1}
    return rows, control


def proxy_stream(regions):
    """The proxy leg's requests, drawn from a seed: (seconds since the last
    request, kind, key, region, arguments), kind one of put / get / head /
    list / delete / mpu."""
    import numpy as np

    rng = np.random.default_rng(PROXY_SEED)
    keys = [f"p{i % 2}/obj-{i}" for i in range(PROXY_KEYS)]
    out = []
    for i in range(PROXY_REQUESTS):
        region = regions[int(rng.integers(0, len(regions)))]
        key = keys[i] if i < len(keys) else keys[int(rng.integers(0, len(keys)))]
        kind = ("put" if i < len(keys) else
                ["put", "get", "head", "list", "delete", "mpu"][int(rng.choice(
                    6, p=[0.12, 0.6, 0.07, 0.1, 0.04, 0.07]))])
        args = {}
        if kind == "put":
            args["body"] = rng.bytes(int(rng.integers(1, 4096)))
        elif kind == "get":
            r = rng.random()
            if r < 0.2:
                a = int(rng.integers(0, 4200))
                args["range"] = f"bytes={a}-{a + int(rng.integers(0, 255))}"
            elif r < 0.3:
                args["range"] = f"bytes=-{int(rng.integers(1, 64))}"
            c = rng.random()
            if c < 0.1:
                args["cond"] = "If-None-Match"
            elif c < 0.15:
                args["cond"] = "If-Match"
        elif kind == "list":
            args = {"max_keys": int(rng.integers(1, 4)),
                    "delimiter": "/" if rng.random() < 0.5 else None,
                    "prefix": "p1/" if rng.random() < 0.3 else "",
                    "resume": rng.random() < 0.6}
        elif kind == "mpu":
            args["parts"] = [rng.bytes(int(rng.integers(1, 2048)))
                             for _ in range(int(rng.integers(1, 4)))]
        out.append((float(rng.exponential(PROXY_STEP_S)), kind, key, region,
                    args))
    return out


def _http(endpoint, method, path, body=None, headers=None) -> tuple:
    import http.client
    from urllib.parse import urlparse

    u = urlparse(endpoint)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=30)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, resp.read(), dict(resp.getheaders())
    finally:
        conn.close()


def _digest(data) -> str:
    import hashlib

    return hashlib.sha256(data).hexdigest()[:16]


def proxy_leg(dev) -> dict:
    """The S3 proxy over a VirtualStore on the card (its own SkyStore
    controller, kernel engine) against a second store on the CPU (torch
    engine) driven by direct ``dispatch``, both on one virtual clock: every
    request's status, body digest and ETag equal."""
    from repro_torch.core import api
    from repro_torch.core.backends import make_backends
    from repro_torch.core.costmodel import pick_regions
    from repro_torch.core.s3_proxy import S3Proxy
    from repro_torch.core.virtual_store import VirtualStore
    from repro_torch.kernels import flash_attention, ttl_scan

    cat = pick_regions(3)
    regions = cat.region_names()
    clk = VirtualClock()
    wire = VirtualStore(cat, make_backends(list(regions), "memory"), mode="FB",
                        clock=clk, device=dev)
    direct = VirtualStore(cat, make_backends(list(regions), "memory"),
                          mode="FB", clock=clk, device="cpu")
    stream = proxy_stream(regions)
    proxies = {r: S3Proxy(wire, r).start() for r in regions}
    bucket = "smoke"
    mismatches, codes, n_http = [], {}, 0
    etags, token = {}, None

    def run_direct(req):
        """Direct dispatch as the proxy renders it: (status, body, etag)."""
        try:
            resp = direct.dispatch(req)
        except api.ApiError as e:
            return e.http_status, None, getattr(e, "etag", None)
        return 200, resp, getattr(resp, "etag", None)

    def send(region, method, path, body=None, headers=None):
        nonlocal n_http
        n_http += 1
        st, data, hdrs = _http(proxies[region].endpoint, method, path, body,
                               headers)
        codes[st] = codes.get(st, 0) + 1
        return st, data, (hdrs.get("ETag") or "").strip('"') or None

    def check(i, kind, got, want):
        if got != want:
            mismatches.append({"i": i, "kind": kind, "wire": got,
                               "direct": want})

    try:
        st, _, _ = send(regions[0], "PUT", f"/{bucket}")
        check(-1, "bucket", st, run_direct(api.CreateBucketRequest(bucket))[0])
        ttl_scan.ttl_cost_surface.launches = 0
        flash_attention.reset_launches()
        for i, (dt, kind, key, region, args) in enumerate(stream):
            clk.t += dt
            path = f"/{bucket}/{key}"
            if kind == "put":
                got = send(region, "PUT", path, args["body"])
                st, resp, etag = run_direct(api.PutRequest(
                    bucket, key, region, body=args["body"]))
                want = (st, b"" if st == 200 else None, etag)
                got = (got[0], b"" if got[0] == 200 else None, got[2])
                if st == 200:
                    etags[key] = etag
            elif kind in ("get", "head"):
                headers, rng_ = {}, None
                if "range" in args:
                    headers["Range"] = args["range"]
                    rng_ = api.parse_range_header(args["range"])
                cond = args.get("cond")
                if cond:
                    headers[cond] = f'"{etags.get(key, "none")}"'
                match = headers.get("If-Match")
                none_match = headers.get("If-None-Match")
                if kind == "get":
                    st, data, etag = send(region, "GET", path,
                                          headers=headers)
                    got = (st, _digest(data) if st in (200, 206) else None,
                           etag if st in (200, 206, 304) else None)
                    w_st, resp, w_etag = run_direct(api.GetRequest(
                        bucket, key, region, range_=rng_, if_match=match,
                        if_none_match=none_match))
                    if w_st == 200 and resp.content_range is not None:
                        w_st = 206
                    want = (w_st, _digest(resp.body) if w_st in (200, 206)
                            else None,
                            w_etag if w_st in (200, 206, 304) else None)
                else:
                    st, _data, etag = send(region, "HEAD", path,
                                           headers={k: v for k, v in headers.items()
                                                    if k != "Range"})
                    got = (st, etag if st in (200, 304) else None)
                    w_st, _resp, w_etag = run_direct(api.HeadRequest(
                        bucket, key, if_match=match, if_none_match=none_match))
                    want = (w_st, w_etag if w_st in (200, 304) else None)
            elif kind == "list":
                q = f"?list-type=2&max-keys={args['max_keys']}"
                if args["prefix"]:
                    q += f"&prefix={args['prefix']}"
                if args["delimiter"]:
                    q += f"&delimiter={args['delimiter']}"
                resume = token if args["resume"] else None
                if resume:
                    q += f"&continuation-token={resume}"
                st, data, _ = send(region, "GET", f"/{bucket}{q}")
                text = data.decode()
                got = (st, [s.split("</Key>")[0] for s in text.split("<Key>")[1:]],
                       [s.split("</Prefix>")[0] for s in
                        text.split("<CommonPrefixes><Prefix>")[1:]],
                       text.split("<NextContinuationToken>")[1].split("<")[0]
                       if "<NextContinuationToken>" in text else None)
                w_st, resp, _ = run_direct(api.ListRequest(
                    bucket, prefix=args["prefix"], max_keys=args["max_keys"],
                    continuation_token=resume, delimiter=args["delimiter"]))
                want = ((w_st, [s.key for s in resp.contents],
                         list(resp.common_prefixes),
                         resp.next_continuation_token) if w_st == 200
                        else (w_st, [], [], None))
                token = got[3]
            elif kind == "delete":
                got = send(region, "DELETE", path)[0]
                want = run_direct(api.DeleteObjectRequest(bucket, key,
                                                          region=region))[0]
                want = 204 if want == 200 else want
            else:
                st, data, _ = send(region, "POST", f"{path}?uploads")
                uid = data.split(b"<UploadId>")[1].split(b"</UploadId>")[0].decode()
                w_uid = run_direct(api.CreateMultipartRequest(
                    bucket, key, region))[1].upload_id
                got, want = [st, uid], [200, w_uid]
                for n, part in enumerate(args["parts"], start=1):
                    got.append(send(region, "PUT",
                                    f"{path}?partNumber={n}&uploadId={uid}",
                                    part)[2])
                    want.append(run_direct(api.UploadPartRequest(
                        w_uid, n, part))[1].etag)
                st, data, _ = send(region, "POST", f"{path}?uploadId={uid}")
                w_st, resp, w_etag = run_direct(api.CompleteMultipartRequest(
                    bucket, key, region, w_uid))
                got.append((st, data.split(b"&quot;")[1].decode()
                            if st == 200 else None))
                want.append((w_st, w_etag))
                if w_st == 200:
                    etags[key] = w_etag
            check(i, kind, got, want)
        launches = ttl_scan.ttl_cost_surface.launches
        flash_launches = flash_attention.flash_attention_bshd.launches
    finally:
        for p in proxies.values():
            p.stop()
    same_tables = wire.meta.backup() == direct.meta.backup()
    refreshes = wire.meta.ctl.n_refreshes
    ok = (not mismatches and same_tables and launches == refreshes > 0
          and direct.meta.ctl.n_refreshes == refreshes
          and flash_launches == 0
          and wire.meta.ctl.device.type == "cuda")
    return {"ok": ok, "requests": len(stream),
            "http_requests": n_http, "status_codes": codes,
            "mismatches": mismatches[:5], "n_mismatches": len(mismatches),
            "metadata_tables_identical": same_tables,
            "refreshes": refreshes, "kernel_launches": launches,
            "other_kernel_launches": flash_launches,
            "virtual_seconds": clk.t}


def phase_live(dev) -> dict:
    """The live plane on the card: the large-tier differential on the kernel
    engine against the same differential on the torch CPU engine, a traced
    live replay, SkyStore's golden fixtures and their control, and the S3
    proxy leg."""
    import torch
    from repro_torch.core.costmodel import pick_regions
    from repro_torch.core.replay import run_live_plane
    from repro_torch.core.workloads import make_workload
    from repro_torch.kernels import flash_attention, ttl_scan

    cat = pick_regions(9)
    trace = make_workload("zipfian", cat.region_names(), seed=7, tier="large")
    n_ev = len(trace.events)

    ttl_scan.ttl_cost_surface.launches = 0
    flash_attention.reset_launches()
    rep_k, secs_k, walls_k = timed_differential(trace, cat, dev)
    launches = ttl_scan.ttl_cost_surface.launches
    flash_launches = flash_attention.flash_attention_bshd.launches
    rep_t, secs_t, walls_t = timed_differential(trace, cat, "cpu")
    # Two more runs in the other order (kernel, torch, torch, kernel): the
    # host varies between runs by more than a refresh's share of the live
    # plane, so each engine's rate is reported from two runs.
    _rep, secs_t2, _walls = timed_differential(trace, cat, "cpu")
    _rep, secs_k2, _walls = timed_differential(trace, cat, dev)
    del _rep, _walls
    refreshes = {name: controller_refreshes(run)
                 for name, run in zip(("sim", "live"), rep_k.planes)}
    refreshes_t = {name: controller_refreshes(run)
                   for name, run in zip(("sim", "live"), rep_t.planes)}
    same = {
        "decisions": all(a.decisions == b.decisions and a.holders == b.holders
                         for a, b in zip(rep_k.planes, rep_t.planes)),
        "components": all(a.report.components() == b.report.components()
                          for a, b in zip(rep_k.planes, rep_t.planes)),
        "counters": all(a.report.counters() == b.report.counters()
                        for a, b in zip(rep_k.planes, rep_t.planes)),
        "report": rep_k.to_json() == rep_t.to_json(),
        "refreshes": refreshes == refreshes_t,
    }
    diff_ok = (rep_k.ok() and rep_k.n_placement_divergence == 0
               and rep_k.n_holder_divergence == 0
               and rep_k.latency["max_rel_delta"] == 0.0)

    # The live plane alone, traced: where the card's time goes, its idle
    # share, and no device op but a refresh's three.
    prof = device_profile(lambda: run_live_plane(
        trace, cat, "skystore", routing="auto", device=dev))
    traced = {k: sum(o["count"] for key, o in prof.get("ops", {}).items()
                     if name in key) for k, name in REFRESH_OPS.items()}
    traced["other"] = sum(o["count"] for key, o in prof.get("ops", {}).items()
                          if not any(n in key for n in REFRESH_OPS.values()))
    traced_ok = "ops" not in prof or (traced["other"] == 0 and all(
        traced[k] <= refreshes["live"] for k in REFRESH_OPS))
    # And under cProfile: where the live plane's host time goes.
    host = host_profile(lambda: run_live_plane(
        trace, cat, "skystore", routing="auto", device=dev), top=15, focus=(
        "_refresh_batched", "_ttl_decide", "_handle_get", "_policy_put",
        "expire_replicas", "route_chunk", "_drive_live_spine"))

    golden, control = golden_live(dev)
    proxy = proxy_leg(dev)
    torch.cuda.synchronize()

    total = sum(refreshes.values())
    ok = (diff_ok and all(same.values()) and launches == total > 0
          and flash_launches == 0 and traced_ok
          and all(g["ok"] for g in golden) and control["caught"]
          and proxy["ok"])
    med = statistics.median
    emit("live", ok=ok, events=n_ev, gets=rep_k.n_get_checked,
         buckets=len(trace.buckets), regions=len(cat.region_names()),
         objects=trace.stats()["objects"],
         differential={"summary": rep_k.summary_line(),
                       "placement_divergence": rep_k.n_placement_divergence,
                       "holder_divergence": rep_k.n_holder_divergence,
                       "counter_diffs": rep_k.counter_diffs,
                       "max_rel_cost_delta": rep_k.max_rel_cost_delta,
                       "latency_max_rel_delta": rep_k.latency["max_rel_delta"],
                       "ok": diff_ok},
         identical_to_torch_cpu=same, refreshes=refreshes,
         kernel_launches=launches, other_kernel_launches=flash_launches,
         events_per_s={
             "kernel_cuda": {p: [n_ev / secs_k[p], n_ev / secs_k2[p]]
                             for p in ("sim", "live")},
             "torch_cpu": {p: [n_ev / secs_t[p], n_ev / secs_t2[p]]
                           for p in ("sim", "live")},
             "order": "kernel, torch, torch, kernel"},
         refresh_us_host_median={
             "kernel_cuda": {p: 1e6 * med(walls_k[p]) for p in walls_k
                             if walls_k[p]},
             "torch_cpu": {p: 1e6 * med(walls_t[p]) for p in walls_t
                           if walls_t[p]}},
         traced_device_ops=traced, traced_live_replay=prof,
         profiled_live_replay=host,
         golden=golden, golden_control=control, proxy=proxy,
         components=rep_k.live_costs, counters=rep_k.sim_counters)
    if not ok:
        raise SystemExit("live-plane check failed")
    return {"launches": launches, "proxy_launches": proxy["kernel_launches"]}


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
#: hubert-xlarge's attention call in the encode phase (B 4, H 16, S 1024,
#: D 80, not causal), and the same at a length that is no multiple of 128.
HUBERT_ATTN = (4, 16, 16, 1024, 1024, 80, False, 0, "bfloat16")
HUBERT_ATTN_1000 = (4, 16, 16, 1000, 1000, 80, False, 0, "bfloat16")
#: A large non-causal f32 call (B 2, H 16, S 1024, D 64): the simt
#: kernel's rate once every SM has whole waves of work (timed only).
SIMT_LARGE = (2, 16, 16, 1024, 1024, 64, False, 0, "float32")
#: qwen2-moe-a2.7b's calls in the moe_serve phase: prefill (B 4, 16 / 16
#: heads, group 1, S 1024, D 128, causal) and a decode step late in its
#: 1056-slot cache.
MOE_PREFILL = (4, 16, 16, 1024, 1024, 128, True, 0, "bfloat16")
MOE_DECODE = (4, 16, 16, 1, 1056, 128, True, 1040, "bfloat16")
#: Each bf16 route forced on cases of its own: group 7 at D 128
#: (qwen2-vl-7b 28/4, deepseek-coder-33b 56/8), a chunk at an offset,
#: the 8,192-key decode, and D 80 / 96 on the padded wgmma tile.
FLASH_ROUTE_CASES = [
    ((2, 28, 4, 333, 333, 128, True, 0, "bfloat16"), "wgmma"),
    ((1, 56, 8, 200, 200, 128, True, 0, "bfloat16"), "wgmma"),
    ((1, 8, 2, 100, 356, 64, True, 256, "bfloat16"), "wgmma"),
    ((2, 28, 4, 1, 1056, 128, True, 1000, "bfloat16"), "splitkv"),
    (FLASH_DECODE_8K, "splitkv"),
    ((1, 8, 2, 16, 200, 64, True, 150, "bfloat16"), "splitkv"),
    ((2, 2, 2, 200, 200, 80, True, 0, "bfloat16"), "wgmma"),
    ((1, 8, 4, 130, 257, 96, True, 0, "bfloat16"), "wgmma"),
    ((1, 4, 2, 100, 356, 96, False, 0, "bfloat16"), "wgmma"),
    (HUBERT_ATTN_1000, "wgmma"),
]
#: A case may carry two more fields, (..., dtype, window, kv_len): the
#: sliding window and the key count of flash_attention_bshd.
#: gemma3-4b's calls in the gemma_serve phase (B 4, 8 / 4 heads of 256): a
#: local layer's prefill, whose 1,024-key window masks half the keys of a
#: 2,048-token prompt; a local layer's decode on its full 1,024-slot ring
#: at position 2,070 (kv_len = the ring), the same ring before it fills
#: (position 700); a global layer's decode at 2,070 of its 2,080-slot cache
#: (kv_len 2,071 < Skv).
GEMMA_PREFILL = (4, 8, 4, 2048, 2048, 256, True, 0, "bfloat16", 1024, None)
GEMMA_DECODE_RING = (4, 8, 4, 1, 1024, 256, False, 2070, "bfloat16", None,
                     1024)
GEMMA_DECODE_RING_FILLING = (4, 8, 4, 1, 1024, 256, False, 700, "bfloat16",
                             None, 701)
GEMMA_DECODE_GLOBAL = (4, 8, 4, 1, 2080, 256, False, 2070, "bfloat16", None,
                       2071)
#: nemotron-4-340b's calls in the mixers phase (B 2, 96 / 8 heads of 192:
#: a group of 12), prefill and a decode step at 1,031 of its 1,032 slots.
NEMOTRON_PREFILL = (2, 96, 8, 1024, 1024, 192, True, 0, "bfloat16")
NEMOTRON_DECODE = (2, 96, 8, 1, 1032, 192, False, 1031, "bfloat16", None,
                   1032)
#: deepseek-v2-lite-16b's MLA prefill (B 2, 16 heads, Dk 192; V zero-padded
#: from 128 to 192 by the model).
DEEPSEEK_PREFILL = (2, 16, 16, 1024, 1024, 192, True, 0, "bfloat16")
#: f32 at D 256 and 192 on simt, windowed and with a key count.
SIMT_D256 = (1, 8, 4, 512, 512, 256, True, 0, "float32", 128, None)
SIMT_D192 = (1, 8, 2, 256, 300, 192, False, 0, "float32", None, 280)
#: Each route forced at D 192 and 256, the masks among the cases.
LARGE_D_ROUTE_CASES = [
    (GEMMA_PREFILL, "wgmma"),
    (NEMOTRON_PREFILL, "wgmma"),
    (DEEPSEEK_PREFILL, "wgmma"),
    ((1, 4, 2, 333, 400, 256, True, 67, "bfloat16", 65, None), "wgmma"),
    ((1, 4, 2, 200, 333, 192, False, 0, "bfloat16", None, 250), "wgmma"),
    (GEMMA_DECODE_RING, "splitkv"),
    (GEMMA_DECODE_RING_FILLING, "splitkv"),
    (GEMMA_DECODE_GLOBAL, "splitkv"),
    (NEMOTRON_DECODE, "splitkv"),
    ((1, 8, 2, 16, 300, 256, True, 200, "bfloat16", 70, None), "splitkv"),
    (SIMT_D256, "simt"),
    (SIMT_D192, "simt"),
    ((1, 4, 4, 1, 200, 256, False, 150, "float32", None, 151), "simt"),
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


def case_masks(case) -> dict:
    """The window and key count a case carries (none for 9 fields)."""
    return {"window": case[9], "kv_len": case[10]} if len(case) > 9 else {}


def flash_inputs(case, dev):
    import numpy as np
    import torch

    b, hq, hkv, sq, skv, d, _causal, _off, dtype = case[:9]
    rng = np.random.default_rng(b * 31 + sq + skv)
    shapes = ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d))
    return [torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
            .to(dev, getattr(torch, dtype)) for sh in shapes]


def flash_bound_ms(case) -> tuple:
    """Least time for one call on these inputs: Q and O once, the K/V rows
    some query attends once, over the HBM rate; against 4 * D operations per
    attended (query, key) pair (two products) over the peak rate of the
    inputs' type.  A pair is attended if its key lies below ``kv_len``, at
    or before the query when causal, and inside the window."""
    b, hq, hkv, sq, skv, d, causal, off, dtype = case[:9]
    masks = case_masks(case)
    window, kv_len = masks.get("window"), masks.get("kv_len")
    top = skv if kv_len is None else min(skv, kv_len)
    spans = []
    for i in range(sq):
        hi = min(top, off + i + 1) if causal else top
        lo = max(0, off + i - window + 1) if window else 0
        spans.append((lo, max(lo, hi)))
    pairs = sum(hi - lo for lo, hi in spans)
    kv_rows = max(0, max(hi for _lo, hi in spans) - min(lo for lo, _hi in spans))
    item = 2 if dtype == "bfloat16" else 4
    n_bytes = item * (2 * b * hq * sq * d + 2 * b * hkv * kv_rows * d)
    rate = BF16_OPS_PER_S if dtype == "bfloat16" else F32_OPS_PER_S
    ops_s = 4 * b * hq * pairs * d / rate
    bytes_s = n_bytes / HBM_BYTES_PER_S
    return (1e3 * max(bytes_s, ops_s),
            "bytes" if bytes_s >= ops_s else "operations")


def sdpa_call(case, q, k, v):
    """The library yardstick: one scaled_dot_product_attention call on the
    same inputs ([B, H, S, D], GQA in the call).  The keys past the last
    live one are sliced off (a decode step at q_offset attends keys 0 ..
    q_offset, or 0 .. kv_len - 1: SDPA without a mask over those keys).  A
    window, or a causal chunk at an offset, takes a boolean mask, and then
    K/V repeated to the query heads outside the timed call (the fused
    kernels with a mask take no GQA)."""
    import torch
    import torch.nn.functional as F

    sq, skv, causal, off = case[3], case[4], case[6], case[7]
    masks = case_masks(case)
    window, kv_len = masks.get("window"), masks.get("kv_len")
    hi = skv if kv_len is None else min(skv, kv_len)
    if causal:
        hi = min(hi, off + sq)
    k, v = k[:, :, :hi], v[:, :, :hi]
    if window is None and (not causal or off == 0 or sq == 1):
        return lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal and off == 0, enable_gqa=True)
    qpos = off + torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(hi, device=q.device)[None, :]
    allowed = torch.ones((sq, hi), dtype=torch.bool, device=q.device)
    if causal:
        allowed &= kpos <= qpos
    if window is not None:
        allowed &= kpos > qpos - window
    group = q.shape[1] // k.shape[1]
    k, v = (t.repeat_interleave(group, dim=1) for t in (k, v))
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=allowed)


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


def layer0_compare(out, q, k, v, causal, q_offset, scale=None,
                   **masks) -> dict:
    """A bf16 route's output for a model's attention call against the plain
    version on the same inputs, with q x scale rounded to bf16 first, as
    the TPU kernel (and each bf16 route) rounds it: each row within
    BF16_TIGHT of its largest value.  At random init ``init_params``, like
    the reference's initialiser, draws a stacked leaf with the layer count
    as its fan-in, so q, k and v come out ~sqrt(d / layers) times unit
    scale, layer 0's logits reach the hundreds and its softmax is one-hot;
    the rounding of q alone then moves the argmax of near-tied rows
    (recorded beside, against the unrounded plain version).  So this check
    mostly sees which key each row picks; a route's numerics rest on the
    flash phase's random-input cases."""
    import torch
    from repro_torch.kernels import flash_attention as fa

    s = fa.softmax_scale(q.shape[-1]) if scale is None else scale
    q_rounded = (q.float() * s).to(q.dtype)
    row = flash_compare(out, fa.plain(q_rounded, k, v, causal, q_offset,
                                      scale=1.0, **masks), "bfloat16")
    row["ok"] = (bool(torch.isfinite(out).all())
                 and row["max_err_over_row_max"] <= BF16_TIGHT)
    unrounded = flash_compare(out, fa.plain(q, k, v, causal, q_offset, scale,
                                            **masks), "bfloat16")
    row["vs_unrounded_plain (recorded)"] = {
        key: unrounded[key] for key in ("max_abs_err", "max_err_over_row_max")}
    return row


def _bshd(x):
    return x.transpose(1, 2)


def flash_launch(route, q, k, v, causal, off, **masks):
    """``route`` forced on ``[B, S, H, D]`` inputs, with the planner's
    splits (the ``splitkv`` route plans itself on every call it takes)."""
    from repro_torch.kernels import flash_attention as fa

    return fa._launch(route, q, k, v, causal, off,
                      fa.plan(q, k, causal, off, **masks)[1], **masks)


def flash_check(case, dev, route=None) -> dict:
    """One call on ``route`` (planned if None) against the plain version, in
    the [B, H, S, D] layout of ``ops.flash_attention`` (strided views of the
    kernels' [B, S, H, D])."""
    import torch
    from repro_torch.kernels import flash_attention as fa

    causal, off, dtype = case[6], case[7], case[8]
    masks = case_masks(case)
    q, k, v = (_bshd(x) for x in flash_inputs(case, dev))
    planned = fa.plan(q, k, causal, off, **masks)[0]
    if route is None:
        got = fa.flash_attention_bshd(q, k, v, causal=causal, q_offset=off,
                                      **masks)
    else:
        got = flash_launch(route, q, k, v, causal, off, **masks)
    want = fa.plain(q, k, v, causal, off, **masks)
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
        n_live = fa.live_range(case[3], case[4], case[6], case[7])[1]
        b, _hq, hkv = case[:3]
        return fa.split_ranges(n_live, fa.decode_splits(b * hkv, n_live))[-1]

    todo = [
        ("splitkv", FLASH_DECODE, "the last live key left out (mask off by "
         "one)", FLASH_DECODE[7], {}),
        ("splitkv", FLASH_DECODE_8K, "the last split left out",
         last_split(FLASH_DECODE_8K)[0], {}),
        ("wgmma", FLASH_PREFILL, "the last 64-key tile left out",
         FLASH_PREFILL[4] - 64, {}),
        ("wgmma", HUBERT_ATTN_1000, "the last 64 keys left out (D 80, "
         "padded tile, not causal)", HUBERT_ATTN_1000[4] - 64, {}),
        ("simt", FLASH_F32, "the last 16-key tile left out (f32)",
         FLASH_F32[4] - 16, {}),
        ("wgmma", GEMMA_PREFILL, "the window's first 64 keys left out (D "
         "256: window 960 for 1,024)", GEMMA_PREFILL[4], {"window": 960}),
        ("splitkv", GEMMA_DECODE_GLOBAL, "the last 64 live keys left out "
         "(D 256: kv_len 2,007 for 2,071)", GEMMA_DECODE_GLOBAL[4],
         {"kv_len": 2007}),
        ("simt", SIMT_D256, "the window one key narrower (f32, D 256)",
         SIMT_D256[4], {"window": SIMT_D256[9] - 1}),
    ]
    out = []
    for route, case, defect, n_keys, defect_masks in todo:
        causal, off = case[6], case[7]
        masks = case_masks(case)
        q, k, v = (_bshd(x) for x in flash_inputs(case, dev))
        got = flash_launch(route, q, k[:, :n_keys], v[:, :n_keys], causal,
                           off, **{**masks, **defect_masks})
        want = fa.plain(q, k, v, causal, off, **masks)
        torch.cuda.synchronize()
        row = flash_compare(got, want, case[8])
        tol = FLASH_TOL[case[8]]
        out.append({"route": route, "case": list(case), "defect": defect,
                    "keys": n_keys, **row,
                    "caught_by_reference_tol": row["max_excess_over_tol"] > 0,
                    "caught": not row["ok"], "tol": tol})
    return out


def flash_timing(case, dev, route: str, n_per: int, cold: bool = False) -> dict:
    """A route's time on one case: CUDA events over back-to-back calls (warm
    L2), the profiler's device time, optionally with L2 flushed, beside the
    plain version's, SDPA's and the bound."""
    import torch
    from repro_torch.kernels import flash_attention as fa

    causal, off = case[6], case[7]
    masks = case_masks(case)
    q, k, v = flash_inputs(case, dev)
    qs, ks, vs = _bshd(q), _bshd(k), _bshd(v)

    splits = fa.plan(qs, ks, causal, off, **masks)[1]

    def call():
        return fa._launch(route, qs, ks, vs, causal, off, splits, **masks)

    ms = cuda_ms(call, n_per)
    prof = device_profile(lambda: [call() for _ in range(n_per)])
    bound_ms, bound_by = flash_bound_ms(case)
    row = {"case": list(case), "route": route, "ms": ms,
           "device_us": route_device_us(prof, route),
           "plain_ms": cuda_ms(lambda: fa.plain(qs, ks, vs, causal, off,
                                                **masks), 3),
           "library_ms": cuda_ms(sdpa_call(case, q, k, v), n_per),
           "bound_ms": bound_ms, "bound_by": bound_by,
           "share_of_bound": bound_ms / ms}
    if row["device_us"]:
        row["device_share_of_bound"] = bound_ms / (1e-3 * row["device_us"])
    else:
        row["device_not_measured"] = prof.get(
            "not_measured", f"no kernel of the {route} route in the profile")
    width = 64 * -(-case[5] // 64)     # whole 64-column swizzle atoms
    if route == "wgmma" and width != case[5]:
        # The padded tile's products: scores at the true depth, P . V at
        # the padded width; the bound counts the true D's only.
        row["padded_width"] = width
        row["padded_work_factor"] = (case[5] + width) / (2 * case[5])
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
    planned = FLASH_CASES + [FLASH_PREFILL, FLASH_DECODE, FLASH_F32,
                             HUBERT_ATTN, MOE_PREFILL, MOE_DECODE,
                             GEMMA_PREFILL, GEMMA_DECODE_RING,
                             GEMMA_DECODE_GLOBAL, NEMOTRON_PREFILL,
                             NEMOTRON_DECODE, DEEPSEEK_PREFILL]
    todo = ([(c, None) for c in planned] + FLASH_ROUTE_CASES
            + LARGE_D_ROUTE_CASES)
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
        "wgmma_hubert": flash_timing(HUBERT_ATTN, dev, "wgmma", 20),
        "wgmma_hubert_1000": flash_timing(HUBERT_ATTN_1000, dev, "wgmma", 20),
        "simt_f32": flash_timing(FLASH_F32, dev, "simt", 50),
        # 20 calls a profile at least: in this script's run the profiler
        # recorded no device time for every row of 10 (PERF.md §7).
        "simt_f32_large": flash_timing(SIMT_LARGE, dev, "simt", 20),
        "wgmma_moe_prefill": flash_timing(MOE_PREFILL, dev, "wgmma", 20),
        "splitkv_moe_decode": flash_timing(MOE_DECODE, dev, "splitkv", 200,
                                           cold=True),
        "wgmma_gemma_prefill": flash_timing(GEMMA_PREFILL, dev, "wgmma", 20),
        "splitkv_gemma_ring_decode": flash_timing(GEMMA_DECODE_RING, dev,
                                                  "splitkv", 200, cold=True),
        "splitkv_gemma_global_decode": flash_timing(
            GEMMA_DECODE_GLOBAL, dev, "splitkv", 200, cold=True),
        "wgmma_nemotron_prefill": flash_timing(NEMOTRON_PREFILL, dev,
                                               "wgmma", 20),
        "splitkv_nemotron_decode": flash_timing(NEMOTRON_DECODE, dev,
                                                "splitkv", 200, cold=True),
        "wgmma_deepseek_prefill": flash_timing(DEEPSEEK_PREFILL, dev,
                                               "wgmma", 20),
        "simt_d256": flash_timing(SIMT_D256, dev, "simt", 20),
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


def phase_serve(dev) -> dict:
    import dataclasses

    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rope_cache, ttl_scan
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import forward, layers
    from repro_torch.serve import prefill
    from repro_torch.tree import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    args = launch_serve.build_parser().parse_args(SERVE_ARGS)
    torch.cuda.reset_peak_memory_stats(dev)
    fa.reset_launches()
    ttl_scan.ttl_cost_surface.launches = 0
    rope_cache.launches = 0
    t0 = time.perf_counter()
    res = launch_serve.run(args)
    wall = time.perf_counter() - t0
    launches = fa.flash_attention_bshd.launches
    route_launches = dict(fa.flash_attention_bshd.route_launches)
    ttl_launches = ttl_scan.ttl_cost_surface.launches
    rope_launches = rope_cache.launches
    peak = torch.cuda.max_memory_allocated(dev)
    cfg, params, tier = res["cfg"], res["params"], res["tier"]
    tier_stats = json.loads(json.dumps(tier.stats))     # before the traced run

    prefills = res["hit"].count(False)
    steps = sum(res["decode_steps"])
    want_launches = cfg.n_layers * (prefills + steps)
    want_routes = {"wgmma": cfg.n_layers * prefills,
                   "splitkv": cfg.n_layers * steps, "simt": 0}
    # The rope / cache-write kernel: one launch a layer in each decode
    # forward, none in prefill.
    want_rope = cfg.n_layers * steps
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

    def tile_left_out(q, k, v, causal, q_offset, **masks):
        return kernel_attn(q, k[:, :-64], v[:, :-64], causal=causal,
                           q_offset=q_offset, **masks)

    def bf16_forward(attn):
        """Logits through ``attn`` in every layer, and the first layer's
        attention output held to the plain version on its own inputs."""
        seen = []

        def first_layer(q, k, v, causal, q_offset, **masks):
            out = attn(q, k, v, causal=causal, q_offset=q_offset, **masks)
            if not seen:
                row = flash_compare(out, fa.plain(q, k, v, causal, q_offset,
                                                  **masks), "bfloat16")
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
    p32 = tree_map(lambda t: t.float(), params)
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
          and rope_launches == want_rope > 0
          and prefills == 3 and tokens_ok and all(payload_ok) and gate_ok
          and bf16_ok)
    emit("serve", ok=ok, args=SERVE_ARGS, layers=cfg.n_layers,
         d_model=cfg.d_model, heads=[cfg.n_heads, cfg.n_kv_heads],
         vocab=cfg.vocab, prefills=prefills, decode_steps=steps,
         flash_launches=launches, flash_launches_expected=want_launches,
         route_launches=route_launches, route_launches_expected=want_routes,
         rope_cache_launches=rope_launches,
         rope_cache_launches_expected=want_rope,
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
            "ttl_launches": ttl_launches, "rope_cache": rope_launches}


# -- the training path ---------------------------------------------------------

TRAIN_ARCH = "llama3.2-1b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR = 4, 1024, 8, 1e-3
#: The store's corpus and virtual clock: 32 shards of 256 tokens, the clock
#: advanced 6 h a batch drawn, so the train region's shard reads pass the
#: controller's 32-sample warmup and its 24-h refresh period (a CPU
#: rehearsal refreshed at the 5th and 9th batches).
CORPUS_SHARDS, SHARD_TOKENS, STORE_STEP_S = 32, 256, 6 * 3600.0
#: Card against CPU: the full-width config cut to 2 layers, f32, 2 steps of
#: ``cfg.optimizer`` with its default schedule on one batch of 2 x 64 from
#: the same params; the first step's gradients are recorded beside them.
#: AdamW's update is ~lr x sign(g) wherever |g| >> eps, so an element whose
#: gradient is at the two devices' rounding noise can take opposite
#: updates: the default schedule's lr at step 1 (3e-6; 0 at step 0) keeps
#: such a flip within 1e-3 of the smallest leaf's scale (the embedding's,
#: ~0.013).
PARITY_LAYERS, PARITY_BATCH, PARITY_SEQ, PARITY_STEPS = 2, 2, 64, 2
PARITY_LOSS_REL, PARITY_PARAM_REL = 1e-4, 1e-3
#: The eval step through the kernel in bf16 against the f32 plain loss: no
#: further from it than 1.5x the plain bf16 loss is, or 1e-3 of it.
EVAL_FACTOR, EVAL_FLOOR = 1.5, 1e-3
LAUNCHERS = ("repro_torch.launch.train", "repro_torch.launch.serve")
LAUNCHER_TIMEOUT_S = 300


def train_flops(cfg, batch: int, seq: int) -> float:
    """Model FLOPs of one train step, remat not counted: 6 N a token for the
    N parameters (the tied lm head's product included) plus causal
    attention's 6 L S d a token (Q K^T and P V over S/2 keys on average,
    2 x 2 x S/2 x d forward, x3 with the backward; d = heads x head dim)."""
    tokens = batch * seq
    d_attn = cfg.n_heads * cfg.resolved_head_dim
    return (6.0 * cfg.param_count() * tokens
            + 6.0 * cfg.n_layers * seq * d_attn * tokens)


def run_launcher(module: str) -> dict:
    """``python -m module`` with its default arguments, in a child process
    on the card."""
    import os

    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(SRC)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", module], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=LAUNCHER_TIMEOUT_S)
    return {"command": f"python -m {module}", "rc": out.returncode,
            "wall_s": time.perf_counter() - t0,
            "stdout_tail": out.stdout[-400:], "stderr_tail": out.stderr[-1500:]}


def leaf_errors(got, want, normwise: bool = False) -> dict:
    """Each leaf's max |got - want| over its largest |want| (``normwise``:
    ||got - want|| over ||want||)."""
    from repro_torch.tree import leaves_with_path

    out = {}
    for (path, a), (_p, b) in zip(leaves_with_path(got), leaves_with_path(want)):
        a, b = a.detach().double().cpu(), b.detach().double().cpu()
        if normwise:
            err = (a - b).norm() / b.norm().clamp_min(1e-300)
        else:
            err = (a - b).abs().max() / b.abs().max().clamp_min(1e-300)
        out["/".join(path)] = float(err)
    return out


def loss_grads(cfg, params, batch):
    """The gradients of the loss at ``params`` (plain attention, as the
    train step takes them), on the CPU."""
    import torch
    from repro_torch.models import loss_fn
    from repro_torch.tree import leaves, unflatten

    leaf = [p.detach().requires_grad_(True) for p in leaves(params)]
    loss, _ = loss_fn(cfg, unflatten(params, leaf), batch, plain_attention=True)
    return unflatten(params, [g.cpu() for g in torch.autograd.grad(loss, leaf)])


def parity_run(cfg, params, batch, dev) -> tuple:
    """On ``dev``: the gradients of the loss at ``params``, then
    ``PARITY_STEPS`` train steps of ``cfg.optimizer`` with its defaults:
    (grads, losses, params), on the CPU."""
    from repro_torch.train import (init_train_state, make_optimizer,
                                   make_train_step)
    from repro_torch.tree import tree_map

    params = tree_map(lambda t: t.to(dev, copy=True), params)
    batch = {k: v.to(dev) for k, v in batch.items()}
    grads = loss_grads(cfg, params, batch)
    _, opt = make_optimizer(cfg.optimizer)
    step = make_train_step(cfg, opt)
    state = init_train_state(cfg, params, opt)
    losses = []
    for _ in range(PARITY_STEPS):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    return grads, losses, tree_map(lambda t: t.cpu(), state.params)


def phase_train(dev, smi: str) -> dict:
    import dataclasses
    import math

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import VirtualStore, make_backends, pick_regions
    from repro_torch.distributed.fault_tolerance import (FleetController,
                                                         kill_region)
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ttl_scan
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import forward, init_params, loss_fn
    from repro_torch.train import (CheckpointManager, SkyStoreShardSource,
                                   init_train_state, make_eval_step,
                                   make_optimizer, make_train_step)
    from repro_torch.tree import leaves, tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    gates, walls = {}, {}

    # 1. The launchers' default commands on the card (fault h: the reduced
    # configs' head dim 8 runs padded on simt), then the serve default in
    # this process, its route counts from 0.
    t0 = time.perf_counter()
    launchers = {m: run_launcher(m) for m in LAUNCHERS}
    gates["launchers_exit_0"] = all(r["rc"] == 0 for r in launchers.values())
    fa.reset_launches()
    res = launch_serve.run(launch_serve.build_parser().parse_args([]))
    torch.cuda.synchronize()
    serve_routes = dict(fa.flash_attention_bshd.route_launches)
    rcfg = res["cfg"]
    serve_simt = rcfg.n_layers * (res["hit"].count(False)
                                  + sum(res["decode_steps"]))
    gates["launcher_serve_on_simt"] = (
        serve_routes == {"wgmma": 0, "splitkv": 0, "simt": serve_simt}
        and serve_simt > 0)
    launcher_serve = {"head_dim": rcfg.resolved_head_dim,
                      "dtype": rcfg.act_dtype, "route_launches": serve_routes,
                      "simt_expected": serve_simt}
    del res
    walls["launchers_s"] = time.perf_counter() - t0

    # 2. Full width, bf16, cfg.optimizer (AdamW with an f32 master), on
    # batches read through the store in the train region; the last batch
    # repeated, so the loss must fall.  TTL-scan launches from 0 for the
    # store's whole use.
    t0 = time.perf_counter()
    cfg = get_config(TRAIN_ARCH)
    clock = VirtualClock()
    cat = pick_regions(3)
    base, west, euro = cat.region_names()
    backends = make_backends(list(cat.region_names()), "memory")
    ttl_scan.ttl_cost_surface.launches = 0
    store = VirtualStore(cat, backends, mode="FB", clock=clock, device=dev)
    SkyStoreShardSource.write_corpus(store, "corpus", base,
                                     n_shards=CORPUS_SHARDS,
                                     tokens_per_shard=SHARD_TOKENS,
                                     vocab=cfg.vocab, seed=0)
    source = SkyStoreShardSource(store, "corpus", west, TRAIN_BATCH, TRAIN_SEQ)
    batches_read = 0

    def next_batch():
        nonlocal batches_read
        clock.t += STORE_STEP_S
        batches_read += 1
        return {k: torch.from_numpy(v).to(dev) for k, v in next(source).items()}

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    _, opt = make_optimizer(cfg.optimizer, lr=TRAIN_LR, warmup_steps=1)
    step_fn = make_train_step(cfg, opt)
    state = init_train_state(cfg, params, opt)
    del params
    losses, step_s, issue_s = [], [], []
    for i in range(TRAIN_STEPS):
        if i < TRAIN_STEPS - 1:
            batch = next_batch()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, m = step_fn(state, batch)
        issue_s.append(time.perf_counter() - t1)     # the host's part
        losses.append(float(m["loss"]))              # waits for the card
        step_s.append(time.perf_counter() - t1)
    peak = torch.cuda.max_memory_allocated(dev)
    # Where a step's device time goes: one more step on the last batch,
    # traced, its result dropped.
    prof = device_profile(lambda: step_fn(state, batch))
    if "ops" in prof:
        prof["ops"] = dict(sorted(prof["ops"].items(),
                                  key=lambda kv: -kv[1]["count"]
                                  * kv[1]["mean_us"])[:15])
    host = host_profile(lambda: step_fn(state, batch), top=15)
    median_s = statistics.median(step_s[1:])
    flops = train_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)
    gates["losses_finite"] = all(math.isfinite(x) for x in losses)
    gates["loss_falls"] = losses[-1] < losses[0]
    full_width = {
        "arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
        "heads": [cfg.n_heads, cfg.n_kv_heads], "vocab": cfg.vocab,
        "params": cfg.param_count(), "dtype": cfg.param_dtype,
        "optimizer": cfg.optimizer, "master": "master" in state.opt_state,
        "lr": TRAIN_LR, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
        "steps": TRAIN_STEPS, "losses": losses, "step_s": step_s,
        "step_ms_median_2_8": 1e3 * median_s,
        "host_issue_ms_median_2_8": 1e3 * statistics.median(issue_s[1:]),
        "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / median_s,
        "model_flops_per_step": flops,
        "flops_note": "6 N T + 6 L S d T (N all parameters, tied head "
                      "included; causal attention; remat not counted)",
        "mfu_of_989e12": flops / median_s / BF16_OPS_PER_S,
        "peak_memory_bytes": peak, "attention": "plain (the reference's "
                                                "train path; no kernel)",
        "traced_step": prof, "host_profile_step": host}
    walls["full_width_train_s"] = time.perf_counter() - t0

    # 5. The eval step through the kernel (wgmma), its route counts from 0,
    # against the same eval in f32 with plain attention.
    t0 = time.perf_counter()
    params = state.params
    eval_batch = next_batch()
    fa.reset_launches()
    l_kernel = float(make_eval_step(cfg)(params, eval_batch)["loss"])
    torch.cuda.synchronize()
    eval_routes = dict(fa.flash_attention_bshd.route_launches)
    with torch.no_grad():
        l_plain = float(loss_fn(cfg, params, eval_batch,
                                plain_attention=True)[0])
        cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                    act_dtype="float32")
        l_f32 = float(loss_fn(cfg32, tree_map(lambda t: t.float(), params),
                              eval_batch, plain_attention=True)[0])
    torch.cuda.empty_cache()
    eval_limit = max(EVAL_FACTOR * abs(l_plain - l_f32), EVAL_FLOOR * l_f32)
    gates["eval_on_wgmma"] = eval_routes == {"wgmma": cfg.n_layers,
                                             "splitkv": 0, "simt": 0}
    gates["eval_kernel_vs_f32"] = (math.isfinite(l_kernel)
                                   and abs(l_kernel - l_f32) <= eval_limit)
    evaluation = {"batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
                  "route_launches": eval_routes, "loss_kernel_bf16": l_kernel,
                  "loss_plain_bf16": l_plain, "loss_plain_f32": l_f32,
                  "kernel_vs_f32": abs(l_kernel - l_f32),
                  "plain_vs_f32": abs(l_plain - l_f32), "limit": eval_limit}

    # 4. The control for fault (i): attention that needs a gradient raises
    # on the card rather than go through the forward-only kernel.
    grad_params = tree_map(lambda t: t.detach().requires_grad_(True), params)
    try:
        forward(cfg, grad_params, eval_batch["inputs"][:1, :128], mode="train")
        control = "no exception"
    except NotImplementedError as exc:
        control = str(exc)
    del grad_params
    gates["grad_attention_raises"] = "no backward" in control
    walls["eval_and_control_s"] = time.perf_counter() - t0

    # 6. The store leg: the trainer half of test_system's failover on these
    # params -- save in the train region, recover into a third, kill the
    # first, recover again bit-equal, one more step.
    t0 = time.perf_counter()
    saved = tree_map(lambda t: t.detach().cpu(), params)
    ckpt = CheckpointManager(store, "ckpt", west, name=cfg.name)
    ckpt.save(TRAIN_STEPS, params)
    del state, params
    torch.cuda.empty_cache()
    fleet = FleetController(ckpt, clock=clock)
    fleet.recover(like=saved, into_region=euro)
    egress_after_first_recover = store.transfers.dollars
    killed = kill_region(backends, west)
    step_no, restored = fleet.recover(like=saved, into_region=euro)
    bit_equal = all(a.dtype == b.dtype and torch.equal(a, b)
                    for a, b in zip(leaves(restored), leaves(saved)))
    state = init_train_state(cfg, tree_map(lambda t: t.to(dev), restored), opt)
    del restored, saved
    state, m = step_fn(state, next_batch())
    resumed_loss = float(m["loss"])
    del state, m
    torch.cuda.empty_cache()
    refreshes = store.meta.ctl.n_refreshes
    ttl_launches = ttl_scan.ttl_cost_surface.launches
    gates["store_recovered_bit_equal"] = (bit_equal and step_no == TRAIN_STEPS
                                          and killed > 0)
    gates["resumed_step_finite"] = math.isfinite(resumed_loss)
    gates["ttl_launches_equal_refreshes"] = (ttl_launches == refreshes >= 1
                                             and store.meta.ctl.device.type
                                             == "cuda")
    store_leg = {"regions": [base, west, euro], "corpus_shards": CORPUS_SHARDS,
                 "shard_tokens": SHARD_TOKENS, "clock_step_s": STORE_STEP_S,
                 "batches_read": batches_read, "virtual_clock_s": clock.t,
                 "checkpoint_bytes": sum(
                     store.head_object("ckpt", k).size
                     for k in store.list_objects("ckpt")),
                 "objects_killed": killed, "recovered_step": step_no,
                 "bit_equal": bit_equal, "resumed_loss": resumed_loss,
                 "egress_dollars": store.transfers.dollars,
                 "egress_dollars_after_first_recover":
                     egress_after_first_recover,
                 "refreshes": refreshes, "ttl_scan_launches": ttl_launches}
    walls["store_leg_s"] = time.perf_counter() - t0

    # 3. Card against CPU in f32: the full-width config cut to 2 layers,
    # the same params and batch, the port's plain paths on the CPU.
    t0 = time.perf_counter()
    pcfg = dataclasses.replace(cfg, n_layers=PARITY_LAYERS,
                               param_dtype="float32", act_dtype="float32")
    p0 = init_params(torch.Generator().manual_seed(1), pcfg, device="cpu")
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab, (PARITY_BATCH, PARITY_SEQ + 1),
                        dtype=np.int32)
    pbatch = {"inputs": torch.from_numpy(toks[:, :-1]),
              "labels": torch.from_numpy(toks[:, 1:])}
    grad_gpu, loss_gpu, params_gpu = parity_run(pcfg, p0, pbatch, dev)
    torch.cuda.empty_cache()
    grad_cpu, loss_cpu, params_cpu = parity_run(pcfg, p0, pbatch,
                                                torch.device("cpu"))
    grad_err = leaf_errors(grad_gpu, grad_cpu)
    grad_norm_err = leaf_errors(grad_gpu, grad_cpu, normwise=True)
    # The f32 rounding spread of these gradients on one device: the batch's
    # gradients against the mean of its two halves' (the same sum in
    # another order), on the card.
    halves = [loss_grads(pcfg, tree_map(lambda t: t.to(dev), p0),
                         {k: v[i:i + 1].to(dev) for k, v in pbatch.items()})
              for i in range(PARITY_BATCH)]
    grad_halves_err = leaf_errors(
        tree_map(lambda *g: sum(g) / len(g), *halves), grad_gpu, normwise=True)
    del halves
    param_err = leaf_errors(params_gpu, params_cpu)
    update_err = leaf_errors(
        tree_map(lambda a, b: a - b, params_gpu, p0),
        tree_map(lambda a, b: a - b, params_cpu, p0))
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(loss_gpu, loss_cpu)]
    gates["card_vs_cpu"] = (max(loss_rel) <= PARITY_LOSS_REL
                            and max(param_err.values()) <= PARITY_PARAM_REL)
    parity = {"layers": PARITY_LAYERS, "batch": PARITY_BATCH,
              "seq": PARITY_SEQ, "steps": PARITY_STEPS,
              "optimizer": f"{cfg.optimizer}, defaults (lr 3e-4, warmup "
                           "100: 0 at step 0, 3e-6 at step 1)",
              "loss_card": loss_gpu, "loss_cpu": loss_cpu,
              "loss_rel_err": loss_rel, "loss_limit": PARITY_LOSS_REL,
              "grad_err_max (recorded)": max(grad_err.values()),
              "grad_err": grad_err,
              "grad_normwise_err_max (recorded)": max(grad_norm_err.values()),
              "grad_normwise_err": grad_norm_err,
              "grad_card_halves_vs_whole_normwise_max (recorded)":
                  max(grad_halves_err.values()),
              "grad_card_halves_vs_whole_normwise": grad_halves_err,
              "param_err_max": max(param_err.values()),
              "param_limit": PARITY_PARAM_REL, "param_err": param_err,
              "update_err_max (recorded)": max(update_err.values()),
              "update_err": update_err}
    del p0, params_gpu, params_cpu, grad_gpu, grad_cpu
    walls["parity_s"] = time.perf_counter() - t0

    ok = all(gates.values())
    emit("train", ok=ok, nvidia_smi=smi, gates=gates, walls=walls,
         launchers=launchers, launcher_serve=launcher_serve,
         full_width=full_width, eval=evaluation, grad_control=control[:200],
         store=store_leg, parity=parity)
    if not ok:
        raise SystemExit("training path check failed: "
                         + ", ".join(k for k, v in gates.items() if not v))
    return {"wgmma_eval": eval_routes["wgmma"],
            "simt_launcher_serve": serve_routes["simt"],
            "ttl_launches": ttl_launches}


# -- the encoder path ----------------------------------------------------------

ENCODE_ARCH = "hubert-xlarge"
#: 4 rows of 1024 frames: ~20 s of audio a row at HuBERT's 50 frames/s.
ENCODE_BATCH, ENCODE_SEQ, ENCODE_WARMUP, ENCODE_STEPS = 4, 1024, 2, 10
#: The frontend configs' train steps (ROADMAP Queue 3 (k)): (arch, layers,
#: why cut), bf16 with AdamW's f32 master, B 4 x 1,024 frames, 3 steps.
#: hubert-xlarge at full depth (~15 GB of parameters and state);
#: qwen2-vl-7b's state (~7.6e9 parameters x 16 B) does not fit a card at
#: its 28 layers, so it runs at full width cut to 2.
FRONTEND_TRAIN = [("hubert-xlarge", None, None),
                  ("qwen2-vl-7b", 2, "7.6e9 parameters x 16 B of AdamW "
                                     "state do not fit 80 GB")]
FRONTEND_TRAIN_STEPS = 3


def frontend_train(arch: str, n_layers, dev) -> dict:
    """(k) ``make_train_step`` for a config whose frontend never reads
    ``embed/w``: finite losses, and ``embed/w`` and its optimizer state
    after every step bit-equal to the optimizer's own update of them from
    a zero gradient on the same tensors (the reference's
    ``value_and_grad`` gives it zero).  The bf16 leaf itself does not move
    at this learning rate (the decay, 3e-5 of it a step, is below a bf16
    step); its f32 master does."""
    import dataclasses
    import math

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.train import frontend_frames
    from repro_torch.models import init_params
    from repro_torch.train import (init_train_state, make_optimizer,
                                   make_train_step)

    cfg = get_config(arch)
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    _, opt = make_optimizer(cfg.optimizer, lr=3e-4, warmup_steps=1)
    state = init_train_state(cfg, params, opt)
    del params
    step = make_train_step(cfg, opt)
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab, (ENCODE_BATCH, ENCODE_SEQ + 1)).astype(np.int32)
    batch = {"inputs": torch.from_numpy(
                 frontend_frames(cfg, toks[:, :-1])).to(dev),
             "labels": torch.from_numpy(toks[:, 1:]).to(dev)}
    losses, step_s, embed_rule, master_moved = [], [], [], []
    for _ in range(FRONTEND_TRAIN_STEPS):
        master = state.opt_state.get("master", state.params)["embed"]["w"]
        master = master.clone()
        zero = {"embed": {"w": torch.zeros_like(state.params["embed"]["w"])}}
        sub = {k: {"embed": v["embed"]} for k, v in state.opt_state.items()}
        with torch.no_grad():
            want, want_state = opt.update({"embed": state.params["embed"]},
                                          zero, sub, state.step)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        step_s.append(time.perf_counter() - t0)
        # the bf16 leaf and every state leaf of it (m, v, the f32 master)
        embed_rule.append(torch.equal(
            state.params["embed"]["w"], want["embed"]["w"]) and all(
            torch.equal(state.opt_state[k]["embed"]["w"], v["embed"]["w"])
            for k, v in want_state.items()))
        master_moved.append(not torch.equal(
            state.opt_state.get("master", state.params)["embed"]["w"],
            master))
        del want, want_state, zero, sub, master
    peak = torch.cuda.max_memory_allocated(dev)
    del state, batch
    torch.cuda.empty_cache()
    return {"arch": arch, "layers": cfg.n_layers, "d_model": cfg.d_model,
            "frontend": cfg.frontend, "optimizer": cfg.optimizer,
            "dtype": cfg.param_dtype, "params": cfg.param_count(),
            "batch": ENCODE_BATCH, "seq": ENCODE_SEQ, "losses": losses,
            "step_s": step_s, "step_ms_last": 1e3 * step_s[-1],
            "peak_memory_bytes": peak,
            "embed_equals_zero_grad_rule": embed_rule,
            "embed_master_moved_by_decay": master_moved,
            "gates": {"finite": all(math.isfinite(x) for x in losses),
                      "embed_zero_grad_rule": all(embed_rule),
                      "embed_master_decays": any(master_moved)}}


def encode_flops(cfg, batch: int, seq: int) -> float:
    """Model FLOPs of one eval step (forward only): 2 N a frame for the N
    parameters plus non-causal attention's 4 L S d a frame (Q K^T and P V
    over all S keys; d = heads x head dim)."""
    frames = batch * seq
    d_attn = cfg.n_heads * cfg.resolved_head_dim
    return (2.0 * cfg.param_count() * frames
            + 4.0 * cfg.n_layers * seq * d_attn * frames)


def phase_encode(dev, smi: str) -> dict:
    import dataclasses
    import math

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.train import frontend_frames
    from repro_torch.models import init_params, layers, loss_fn
    from repro_torch.train import make_eval_step
    from repro_torch.tree import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    gates = {}
    cfg = get_config(ENCODE_ARCH)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab, (ENCODE_BATCH, ENCODE_SEQ + 1)).astype(np.int32)
    batch = {"inputs": torch.from_numpy(
                 frontend_frames(cfg, toks[:, :-1])).to(dev),
             "labels": torch.from_numpy(toks[:, 1:]).to(dev)}
    step = make_eval_step(cfg)

    # The main path: one eval step, its route counts from 0.
    fa.reset_launches()
    l_kernel = float(step(params, batch)["loss"])
    routes = dict(fa.flash_attention_bshd.route_launches)
    gates["one_wgmma_launch_a_layer"] = routes == {
        "wgmma": cfg.n_layers, "splitkv": 0, "simt": 0}

    for _ in range(ENCODE_WARMUP):
        step(params, batch)["loss"].item()
    step_s = []
    for _ in range(ENCODE_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(params, batch)["loss"].item()
        step_s.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated(dev)
    median_s = statistics.median(step_s)
    prof = device_profile(lambda: step(params, batch)["loss"].item())
    attention_us = None
    if "ops" in prof:
        attention_us = sum(o["count"] * o["mean_us"] for key, o in
                           prof["ops"].items()
                           if "flash_prefill_kernel" in key)
        prof["ops"] = dict(sorted(prof["ops"].items(),
                                  key=lambda kv: -kv[1]["count"]
                                  * kv[1]["mean_us"])[:15])

    # Layer 0's attention output against the plain version on its own
    # inputs (``layer0_compare``: layer 0's logits reach ~155 here, q, k, v
    # of std ~5.2 = sqrt(1280 / 48), both recorded), through the kernel
    # and through a control that leaves the last 64 keys out of every
    # layer's call.
    kernel_attn = layers.flash_attention_bshd

    def layer0(attn) -> dict:
        seen = []

        def first_layer(q, k, v, causal, q_offset, scale=None, **masks):
            out = attn(q, k, v, causal=causal, q_offset=q_offset, scale=scale,
                       **masks)
            if not seen:
                row = layer0_compare(out, q, k, v, causal, q_offset, scale,
                                     **masks)
                logits = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                                      k.float()) * fa.softmax_scale(q.shape[-1])
                row["logit_absmax"] = float(logits.abs().max())
                row["qkv_std"] = [float(t.float().std()) for t in (q, k, v)]
                del logits
                seen.append(row)
            return out

        layers.flash_attention_bshd = first_layer
        try:
            step(params, batch)
        finally:
            layers.flash_attention_bshd = kernel_attn
        return seen[0] if seen else {"ok": False,
                                     "not_reached": "no kernel call"}

    def keys_left_out(q, k, v, causal, q_offset, scale=None, **masks):
        return kernel_attn(q, k[:, :-64], v[:, :-64], causal=causal,
                           q_offset=q_offset, scale=scale, **masks)

    attn0 = layer0(kernel_attn)
    attn0_control = layer0(keys_left_out)
    gates["layer0_attention"] = attn0["ok"]
    gates["control_caught"] = not attn0_control["ok"]

    # The eval rule of the train phase: the kernel's bf16 loss against the
    # f32 plain loss of the same weights (bf16 -> f32 is exact).
    with torch.no_grad():
        l_plain = float(loss_fn(cfg, params, batch, plain_attention=True)[0])
        cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                    act_dtype="float32")
        p32 = tree_map(lambda t: t.float(), params)
        l_f32 = float(loss_fn(cfg32, p32, batch, plain_attention=True)[0])
    del p32, params, batch
    torch.cuda.empty_cache()
    limit = max(EVAL_FACTOR * abs(l_plain - l_f32), EVAL_FLOOR * l_f32)
    gates["loss_kernel_vs_f32"] = (math.isfinite(l_kernel)
                                   and abs(l_kernel - l_f32) <= limit)

    trains = [dict(frontend_train(arch, n_layers, dev), depth_cut=why)
              for arch, n_layers, why in FRONTEND_TRAIN]
    for row in trains:
        for name, ok_ in row["gates"].items():
            gates[f"train {row['arch']} {name}"] = ok_

    flops = encode_flops(cfg, ENCODE_BATCH, ENCODE_SEQ)
    ok = all(gates.values())
    emit("encode", ok=ok, nvidia_smi=smi, gates=gates, arch=cfg.name,
         layers=cfg.n_layers, d_model=cfg.d_model,
         heads=[cfg.n_heads, cfg.n_kv_heads],
         head_dim=cfg.resolved_head_dim, causal=cfg.causal,
         dtype=cfg.param_dtype, params=cfg.param_count(),
         batch=ENCODE_BATCH, seq=ENCODE_SEQ, route_launches=routes,
         loss_kernel_bf16=l_kernel, loss_plain_bf16=l_plain,
         loss_plain_f32=l_f32, kernel_vs_f32=abs(l_kernel - l_f32),
         plain_vs_f32=abs(l_plain - l_f32), loss_limit=limit,
         layer0_attention=attn0,
         control={"defect": "the last 64 keys left out of every layer's "
                             "attention call",
                  "layer0_attention": attn0_control,
                  "caught": gates["control_caught"]},
         step_s=step_s, step_ms_median=1e3 * median_s,
         frames_per_s=ENCODE_BATCH * ENCODE_SEQ / median_s,
         model_flops_per_step=flops,
         mfu_of_989e12=flops / median_s / BF16_OPS_PER_S,
         peak_memory_bytes=peak, attention_device_us_traced_step=attention_us,
         traced_step=prof, train_steps=trains)
    if not ok:
        raise SystemExit("encoder path check failed: "
                         + ", ".join(k for k, v in gates.items() if not v))
    return {"wgmma": routes["wgmma"]}



# -- the routed MoE decode kernels (kernels/moe_decode) ------------------------

MOE_DECODE_ARCHS = ("qwen2-moe-a2.7b", "deepseek-v2-lite-16b",
                    "jamba-v0.1-52b")
MOE_DECODE_BATCH = 4
#: The kernels' y against the plain version's on the same bf16 inputs,
#: normwise (``|got - want| / |want|``): both sum in fp32 and round once,
#: so they differ by the sums' order and a bf16 step; a wrong expert or a
#: shared expert left out moves y by about its own size.
MOE_DECODE_TOL = 2.0 ** -7
MOE_KERNELS = ("moe_up_kernel", "moe_down_kernel")


def moe_decode_bound_ms(d: int, f: int, n_experts: int, n_shared: int,
                        n_tok: int, top_k: int, itemsize: int = 2) -> float:
    """Least time for one call of the kernel pair: the distinct routed
    experts' and the shared experts' three matrices (d x f each) read once,
    x read, h (fp32) written and read, y written, over the HBM rate."""
    n_bytes = (itemsize * 3 * d * f * (n_experts + n_shared)
               + itemsize * 2 * n_tok * d
               + 4 * 2 * n_tok * (top_k + n_shared) * f)
    return 1e3 * n_bytes / HBM_BYTES_PER_S


def pair_device_us(fn, names: tuple = MOE_KERNELS, calls: int = 50) -> dict:
    """Mean device us of each named kernel's launch (one a call) and of the
    pair, with the launches the profiler recorded, and the device us of all
    the work of ``calls`` calls over ``calls``, from ``device_profile``."""
    fn()
    prof = device_profile(lambda: [fn() for _ in range(calls)])
    ops = prof.get("ops")
    if not ops:
        return {"not_measured": prof.get("not_measured")}
    per, seen = {}, {}
    for name in names:
        hits = [o for key, o in ops.items() if name in key]
        seen[name] = sum(o["count"] for o in hits)
        per[name] = (sum(o["count"] * o["mean_us"] for o in hits)
                     / max(seen[name], 1))
    return {**per, "pair": sum(per.values()), "launches_seen": seen,
            "calls": calls, "all": 1e6 * prof["device_busy_s"] / calls}


def moe_decode_case(arch: str, dev, seed: int) -> dict:
    """One MoE layer of ``arch`` at full width, bf16, one decode step of
    MOE_DECODE_BATCH tokens on router-like routes (top-k of random
    probabilities, so tokens may share experts): the kernels against the
    plain version at both column tiles, two defects the tolerance must
    catch, and the times of the pair, the plain version and the capacity
    path it replaces, beside the bound of this call's own routes."""
    import math

    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import moe_decode
    from repro_torch.models import layers

    cfg = get_config(arch)
    m, d, b = cfg.moe, cfg.d_model, MOE_DECODE_BATCH
    f = m.d_ff_expert or cfg.d_ff
    gen = torch.Generator(device=dev).manual_seed(seed)

    def draw(*shape):
        return (torch.randn(shape, generator=gen, device=dev)
                / math.sqrt(shape[-2])).to(torch.bfloat16)

    we = [draw(m.n_routed, d, f), draw(m.n_routed, d, f),
          draw(m.n_routed, f, d)]
    ws = ([draw(d, m.n_shared * f), draw(d, m.n_shared * f),
           draw(m.n_shared * f, d)] if m.n_shared else [None] * 3)
    probs = torch.softmax(torch.randn((b, m.n_routed), generator=gen,
                                      device=dev), -1)
    gates, expert = torch.topk(probs, m.top_k, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True)
    x = torch.randn((b, d), generator=gen, device=dev).to(torch.bfloat16)
    n_experts = int(expert.unique().numel())

    def kernel():
        return moe_decode.routed_moe(x, expert, gates, *we, *ws)

    def plain():
        return moe_decode.plain(x, expert, gates, *we, *ws)

    def normwise(got, want):
        return float((got.float() - want.float()).norm()
                     / want.float().norm())

    route = layers.MoERoute(
        probs=probs[:, None], gates=gates[:, None], expert=expert,
        slot=torch.zeros_like(expert),
        keep=torch.ones_like(expert, dtype=torch.bool),
        onehot=torch.nn.functional.one_hot(expert, m.n_routed).float(),
        cap=m.top_k)
    p = dict(zip(("we_gate", "we_up", "we_down"), we))
    if m.n_shared:
        p.update(zip(("ws_gate", "ws_up", "ws_down"), ws))

    def capacity():
        return layers._capacity_moe(cfg, p, x[:, None], x[:, None],
                                    lambda t: t, route)

    with torch.no_grad():
        want = plain()
        err = normwise(kernel(), want)
        err32 = normwise(moe_decode._launch(x, expert, gates, *we, tuple(ws),
                                            32), want)
        controls = {"wrong_expert": normwise(moe_decode.routed_moe(
            x, (expert + 1) % m.n_routed, gates, *we, *ws), want)}
        if m.n_shared:
            controls["no_shared_expert"] = normwise(
                moe_decode.routed_moe(x, expert, gates, *we), want)
        capacity_err = normwise(capacity()[:, 0], want)
        torch.cuda.synchronize()
        ms = cuda_ms(kernel, 50, 7)
        dev_us = pair_device_us(kernel)
        up32_us = pair_device_us(lambda: moe_decode._launch(
            x, expert, gates, *we, tuple(ws), 32)).get("moe_up_kernel")
        plain_ms = cuda_ms(plain, 3, 3)
        capacity_ms = cuda_ms(capacity, 20, 5)
        capacity_us = pair_device_us(capacity, calls=20).get("all")
    bound_ms = moe_decode_bound_ms(d, f, n_experts, m.n_shared, b, m.top_k)
    pair_us = dev_us.get("pair")
    ok = (err <= MOE_DECODE_TOL and err32 <= MOE_DECODE_TOL
          and all(v > MOE_DECODE_TOL for v in controls.values()))
    del we, ws, p, route
    torch.cuda.empty_cache()
    return {"arch": arch, "ok": ok, "batch": b, "dtype": "bfloat16",
            "shape": {"d": d, "f": f, "experts": m.n_routed,
                      "top_k": m.top_k, "n_shared": m.n_shared},
            "distinct_experts": n_experts, "normwise_err": err,
            "normwise_err_tile32": err32, "controls": controls,
            "capacity_normwise_err": capacity_err,
            "ms": ms, "device_us": dev_us, "up_tile32_device_us": up32_us,
            "plain_ms": plain_ms, "capacity_ms": capacity_ms,
            "capacity_device_us": capacity_us,
            "bound_ms": bound_ms, "bound_by": "bytes",
            "share_of_bound_events": bound_ms / ms,
            "share_of_bound_device": (None if not pair_us
                                      else 1e3 * bound_ms / pair_us)}


def phase_moe_decode(dev) -> dict:
    import torch
    from repro_torch.kernels import moe_decode

    torch.backends.cuda.matmul.allow_tf32 = False
    rows = [moe_decode_case(arch, dev, seed=2600 + i)
            for i, arch in enumerate(MOE_DECODE_ARCHS)]
    ok = all(r["ok"] for r in rows)
    emit("moe_decode", ok=ok, tol=MOE_DECODE_TOL, rows=rows,
         build_log=moe_decode.LIBRARY.log[-2000:],
         sass_instructions=sass_instructions(moe_decode.LIBRARY))
    if not ok:
        raise SystemExit("the routed MoE kernels disagree with their plain "
                         "version, or a control was not caught: "
                         + ", ".join(r["arch"] for r in rows if not r["ok"]))
    return {r["arch"]: r for r in rows}


# -- MLA decode in latent space (kernels/mla_decode) --------------------------

MLA_ARCH = "deepseek-v2-lite-16b"
MLA_DECODE_BATCH, MLA_DECODE_MAX_LEN = 4, 16_448
#: The ``dsv2lite-longdoc-hits`` cell's key counts at its first and last
#: decode step: a 16,384-token document's last prompt position re-decoded,
#: then 63 steps, in a 16,448-row cache.
MLA_DECODE_KV_LENS = (16_385, 16_447)
#: o_lat against the plain version's on the same bf16 inputs, by the
#: largest |got - want| over the largest |want|: both keep the softmax in
#: fp32 and round p (the kernels before the softmax's division, the plain
#: version after it) and o once.  A key count off by one, its key planted
#: to dominate every head, moves o by about its own size.
MLA_DECODE_TOL = 2.0 ** -7
MLA_KERNELS = ("mla_decode_split_kernel", "mla_decode_combine_kernel")


def mla_decode_bound_ms(b: int, heads: int, kv_len: int, latent: int = 512,
                        rope: int = 64, itemsize: int = 2) -> float:
    """Least time for one call of the kernel pair: each sequence's
    ``kv_len`` latent and rope rows read once, the queries read and o
    written, over the HBM rate (its FLOPs take a tenth of that)."""
    n_bytes = itemsize * b * (kv_len * (latent + rope)
                              + heads * (latent + rope) + heads * latent)
    return 1e3 * n_bytes / HBM_BYTES_PER_S


def mla_decode_case(kv_len: int, dev, seed: int) -> dict:
    """One MLA layer's decode attention of deepseek-v2-lite-16b at full
    width (16 heads, R 512, rope 64), B 4, bf16, ``kv_len`` keys of a
    16,448-row cache: the kernel pair against the plain version, twice
    (random keys; the last key read planted), two controls that must land
    outside the tolerance (the key count one short with its last key
    planted, one long with the row past it planted), and the times of the
    pair, the plain version, the absorbed einsums over every slot (the path
    it replaced) and SDPA over the per-head K / V decompressed from the
    same rows, beside the pair's bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels import mla_decode
    from repro_torch.models import layers

    cfg = get_config(MLA_ARCH)
    m, b, h = cfg.mla, MLA_DECODE_BATCH, cfg.n_heads
    r, dr, dn, dv = (m.kv_lora_rank, m.qk_rope_dim, m.qk_nope_dim,
                     m.v_head_dim)
    scale = (dn + dr) ** -0.5 * layers.softmax_factor(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    bf = torch.bfloat16

    def draw(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    q_lat, q_rope = draw(b, 1, h, r), draw(b, 1, h, dr)
    ckv = draw(b, MLA_DECODE_MAX_LEN, r)
    krope = draw(b, MLA_DECODE_MAX_LEN, dr)
    q_nope = draw(b, 1, h, dn).to(bf)
    w_uk = (draw(r, h, dn) / r ** 0.5).to(bf)
    w_uv = (draw(r, h, dv) / r ** 0.5).to(bf)

    def planted(row):
        """The caches with ``row`` moved along each sequence's mean query,
        so that it takes nearly all of every head's softmax."""
        mean = q_lat[:, 0].mean(1)
        c = ckv.clone()
        c[:, row] += 60 * mean / mean.norm(dim=-1, keepdim=True)
        return c.to(bf)

    args = (q_lat.to(bf), q_rope.to(bf))
    caches = (ckv.to(bf), krope.to(bf))

    def err(got, want):
        return float((got.float() - want.float()).abs().max()
                     / want.float().abs().max())

    def kernel():
        return mla_decode.mla_decode(*args, *caches, kv_len, scale)

    def plain():
        return mla_decode.plain(*args, *caches, kv_len, scale)

    def einsum_all_slots():
        ckv_f = caches[0].float()
        ql = torch.einsum("bshk,rhk->bshr", q_nope.float(), w_uk.float())
        lg = (torch.einsum("bshr,btr->bhst", ql, ckv_f)
              + torch.einsum("bshk,btk->bhst", args[1].float(),
                             caches[1].float())) * scale
        valid = torch.arange(MLA_DECODE_MAX_LEN, device=dev) < kv_len
        p = torch.softmax(lg.masked_fill(~valid, -1e30), dim=-1)
        return torch.einsum("bhst,btr->bshr", p, ckv_f)

    with torch.no_grad():
        before = mla_decode.launches
        got = kernel()
        launches_a_call = mla_decode.launches - before
        errs = {"random_keys": err(got, plain())}
        controls = {}
        for name, row, n in (("one_key_short", kv_len - 1, kv_len - 1),
                             ("one_key_long", kv_len, kv_len + 1)):
            c = (planted(row), caches[1])
            want = mla_decode.plain(*args, *c, kv_len, scale)
            if row < kv_len:
                errs["last_key_planted"] = err(
                    mla_decode.mla_decode(*args, *c, kv_len, scale), want)
            controls[name] = err(mla_decode.mla_decode(*args, *c, n, scale),
                                 want)
            del c
        k = torch.cat([torch.einsum("btr,rhk->bhtk", caches[0][:, :kv_len],
                                    w_uk),
                       caches[1][:, None, :kv_len].expand(b, h, kv_len, dr)],
                      -1)
        v = torch.einsum("btr,rhv->bhtv", caches[0][:, :kv_len], w_uv)
        q = torch.cat([q_nope, args[1]], -1).transpose(1, 2)

        def sdpa():
            return F.scaled_dot_product_attention(q, k, v, scale=scale)

        torch.cuda.synchronize()
        ms = cuda_ms(kernel, 50, 7)
        dev_us = pair_device_us(kernel, MLA_KERNELS)
        plain_ms = cuda_ms(plain, 3, 3)
        einsum_ms = cuda_ms(einsum_all_slots, 3, 3)
        library_ms = cuda_ms(sdpa, 20, 5)
    bound_ms = mla_decode_bound_ms(b, h, kv_len, r, dr)
    library_bound_ms = 1e3 * 2 * b * h * (kv_len * (dn + dr + dv)
                                          + dn + dr + dv) / HBM_BYTES_PER_S
    pair_us = dev_us.get("pair")
    ok = (launches_a_call == 2
          and all(e <= MLA_DECODE_TOL for e in errs.values())
          and all(e > MLA_DECODE_TOL for e in controls.values()))
    del k, v, q, ckv, krope, caches
    torch.cuda.empty_cache()
    return {"kv_len": kv_len, "ok": ok, "batch": b, "dtype": "bfloat16",
            "shape": {"heads": h, "latent": r, "rope": dr,
                      "max_len": MLA_DECODE_MAX_LEN},
            "splits": mla_decode.split_plan(
                b, kv_len, mla_decode._sm_count(torch.cuda.current_device())),
            "launches_a_call": launches_a_call, "max_abs_err": errs,
            "controls": controls, "ms": ms, "device_us": dev_us,
            "plain_ms": plain_ms, "einsum_all_slots_ms": einsum_ms,
            "library_ms": library_ms, "library_bound_ms": library_bound_ms,
            "bound_ms": bound_ms, "bound_by": "bytes",
            "share_of_bound_events": bound_ms / ms,
            "share_of_bound_device": (None if not pair_us
                                      else 1e3 * bound_ms / pair_us)}


def phase_mla_decode(dev) -> dict:
    import torch
    from repro_torch.kernels import mla_decode

    torch.backends.cuda.matmul.allow_tf32 = False
    rows = [mla_decode_case(kv_len, dev, seed=2800 + i)
            for i, kv_len in enumerate(MLA_DECODE_KV_LENS)]
    ok = all(r["ok"] for r in rows)
    emit("mla_decode", ok=ok, tol=MLA_DECODE_TOL, rows=rows,
         build_log=mla_decode.LIBRARY.log[-2000:],
         sass_instructions=sass_instructions(mla_decode.LIBRARY))
    if not ok:
        raise SystemExit("the MLA decode kernels disagree with their plain "
                         "version, or a control was not caught: kv_len "
                         + ", ".join(str(r["kv_len"]) for r in rows
                                     if not r["ok"]))
    return {r["kv_len"]: r for r in rows}


# -- GQA decode's rope and cache write (kernels/rope_cache) ---------------------

#: (name, arch, Hq, Hkv, D, cache rows): the attention shapes of the configs
#: whose decode takes the kernel; the slot is the position modulo the rows.
ROPE_CACHE_SHAPES = [
    ("qwen2-moe", "qwen2-moe-a2.7b", 16, 16, 128, 64),
    ("llama3.2-1b", "llama3.2-1b", 32, 8, 64, 64),
    ("gemma3-ring", "gemma3-4b", 8, 4, 256, 1024),
    ("gemma3-global", "gemma3-4b", 8, 4, 256, 48),
    ("nemotron", "nemotron-4-340b", 96, 8, 192, 32),
    ("yarn", "llama3.2-1b", 16, 4, 64, 32),
]
ROPE_CACHE_POSITIONS = (0, 2047, 16_446)
ROPE_CACHE_BATCH = 4
ROPE_KERNELS = ("rope_cache_kernel",)


def rope_cache_bound_ms(b: int, hq: int, hkv: int, d: int,
                        itemsize: int = 2) -> float:
    """Least time for one call: q, k, v read, q_out and the two cache rows
    written, the frequency table read, over the HBM rate."""
    n_bytes = 2 * itemsize * b * (hq + 2 * hkv) * d + 4 * d // 2
    return 1e3 * n_bytes / HBM_BYTES_PER_S


def rope_cache_cfg(arch: str, name: str):
    """``arch``'s config; for ``yarn`` llama3.2-1b's with deepseek-v2-lite's
    YaRN table and a cos / sin scale of mscale(1) / mscale(0.707)."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = get_config(arch)
    if name == "yarn":
        yarn = dataclasses.replace(get_config("deepseek-v2-lite-16b").yarn,
                                   mscale=1.0)
        cfg = dataclasses.replace(cfg, rope_theta=10_000.0, yarn=yarn)
    return cfg


def rope_cache_inputs(shape, dtype, dev, seed: int):
    import torch

    _name, _arch, hq, hkv, d, rows = shape
    b = ROPE_CACHE_BATCH
    gen = torch.Generator(device=dev).manual_seed(seed)

    def draw(*dims):
        return torch.randn(dims, generator=gen, device=dev).to(dtype)

    return (draw(b, 1, hq, d), draw(b, 1, hkv, d), draw(b, 1, hkv, d),
            draw(b, rows, hkv, d), draw(b, rows, hkv, d))


def rope_cache_replaced(cfg, q, k, v, kc, vc, pos: int, slot: int):
    """The ops the kernel replaces in ``layers._apply_attn``'s decode step:
    the positions, ``rotate`` for q and k, two ``write_seq`` copies."""
    import torch
    from repro_torch.distributed.sharding import write_seq
    from repro_torch.models import layers

    b, s = q.shape[:2]
    positions = (pos + torch.arange(s, device=q.device))[None, :].expand(b, s)
    q = layers.rotate(cfg, q, positions)
    k = layers.rotate(cfg, k, positions)
    write_seq(kc, slot, k.to(kc.dtype))
    write_seq(vc, slot, v.to(vc.dtype))
    return q


def rope_cache_diff(cfg, inputs, pos: int, slot: int, want_pos: int,
                    want_slot: int) -> tuple:
    """The kernel at (pos, slot) against the replaced ops at (want_pos,
    want_slot): (elements whose bits differ in q, k_cache and v_cache, the
    largest |got - want| over the three)."""
    import torch
    from repro_torch.kernels import rope_cache
    from repro_torch.models import layers

    q, k, v, kc, vc = inputs
    kc_w, vc_w, kc_g, vc_g = kc.clone(), vc.clone(), kc.clone(), vc.clone()
    want = rope_cache_replaced(cfg, q, k, v, kc_w, vc_w, want_pos, want_slot)
    inv, scale = layers._rope_table(q.shape[-1], cfg.rope_theta,
                                    getattr(cfg, "yarn", None), q.device)
    got = rope_cache.rope_cache(q, k, v, kc_g, vc_g, pos, slot, inv, scale)
    view = torch.int16 if q.element_size() == 2 else torch.int32
    pairs = ((got, want), (kc_g, kc_w), (vc_g, vc_w))
    return ([int((a.view(view) != b.view(view)).sum()) for a, b in pairs],
            max(float((a.float() - b.float()).abs().max()) for a, b in pairs))


def host_us(fn, calls: int = 400) -> float:
    """Host microseconds a call of ``fn`` (median of 5 runs of ``calls``
    back-to-back calls, the device synchronised only around each run)."""
    import torch

    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        per.append(1e6 * (time.perf_counter() - t0) / calls)
        torch.cuda.synchronize()
    return statistics.median(per)


def phase_rope_cache(dev) -> dict:
    import torch
    from repro_torch.kernels import rope_cache
    from repro_torch.models import layers

    rows, ok = [], True
    with torch.no_grad():
        for dtype in (torch.bfloat16, torch.float32):
            for shape in ROPE_CACHE_SHAPES:
                cfg = rope_cache_cfg(shape[1], shape[0])
                for i, pos in enumerate(ROPE_CACHE_POSITIONS):
                    inputs = rope_cache_inputs(shape, dtype, dev, 3000 + i)
                    slot = pos % shape[5]
                    fits = rope_cache.fits(cfg.rope, *inputs)
                    diff, err = rope_cache_diff(cfg, inputs, pos, slot, pos,
                                                slot)
                    ok &= fits and diff == [0, 0, 0] and err == 0.0
                    rows.append({"shape": shape[0], "dtype": str(dtype)[6:],
                                 "pos": pos, "slot": slot, "fits": fits,
                                 "elements": [t.numel() for t in
                                              (inputs[0], inputs[3],
                                               inputs[4])],
                                 "differing": diff, "max_abs_err": err})
        shape = ROPE_CACHE_SHAPES[0]
        cfg = rope_cache_cfg(shape[1], shape[0])
        inputs = rope_cache_inputs(shape, torch.bfloat16, dev, 3100)
        pos, slot = 2047, 2047 % shape[5]
        controls = {
            "position_one_high": rope_cache_diff(cfg, inputs, pos + 1, slot,
                                                 pos, slot)[0],
            "slot_one_late": rope_cache_diff(cfg, inputs, pos,
                                             (slot + 1) % shape[5], pos,
                                             slot)[0]}
        caught = (controls["position_one_high"][0] > 0
                  and controls["slot_one_late"][1] > 0)
        q, k, v, kc, vc = inputs
        inv, scale = layers._rope_table(q.shape[-1], cfg.rope_theta, None,
                                        dev)

        def kernel():
            return rope_cache.rope_cache(q, k, v, kc, vc, pos, slot, inv,
                                         scale)

        def replaced():
            return rope_cache_replaced(cfg, q, k, v, kc, vc, pos, slot)

        torch.cuda.synchronize()
        ms = cuda_ms(kernel, 50, 7)
        dev_us = pair_device_us(kernel, ROPE_KERNELS)
        replaced_ms = cuda_ms(replaced, 50, 7)
        replaced_us = pair_device_us(replaced, ROPE_KERNELS).get("all")
        kernel_host = host_us(kernel)
        replaced_host = host_us(replaced)
        fits_host = host_us(lambda: rope_cache.fits(cfg.rope, *inputs))
    b, hq, hkv, d = ROPE_CACHE_BATCH, shape[2], shape[3], shape[4]
    bound_ms = rope_cache_bound_ms(b, hq, hkv, d)
    kernel_us = dev_us.get("rope_cache_kernel")
    timing = {"shape": {"batch": b, "heads": [hq, hkv], "head_dim": d},
              "dtype": "bfloat16", "pos": pos, "ms": ms, "device_us": dev_us,
              "replaced_ms": replaced_ms,
              "replaced_device_us": replaced_us,
              "host_us_a_call": kernel_host,
              "fits_host_us_a_call": fits_host,
              "replaced_host_us_a_call": replaced_host,
              "bound_ms": bound_ms, "bound_by": "bytes",
              "share_of_bound_device": (None if not kernel_us
                                        else 1e3 * bound_ms / kernel_us),
              "max_abs_err": max(r["max_abs_err"] for r in rows),
              "max_differing_elements": max(max(r["differing"])
                                            for r in rows)}
    ok = ok and caught
    emit("rope_cache", ok=ok, rows=rows, controls=controls,
         controls_caught=caught, timing=timing,
         build_log=rope_cache.LIBRARY.log[-2000:],
         sass_instructions=sass_instructions(rope_cache.LIBRARY))
    if not ok:
        raise SystemExit("the rope / cache-write kernel differs from the ops "
                         "it replaces, or a control was not caught")
    return timing


# -- the MoE serving path (qwen2-moe-a2.7b) ------------------------------------

MOE_SERVE_ARGS = ["--arch", "qwen2-moe-a2.7b", "--no-reduced", "--requests",
                  "6", "--batch", "4", "--prompt-len", "1024", "--gen", "32",
                  "--seed", "0", "--device", "cuda"]
MOE_GATE_LEN = 256
#: The f32 gate on simt keeps 2 of the 24 layers: 57 GB of f32 parameters
#: at full depth do not fit beside the bf16 ones.
MOE_F32_LAYERS = 2
#: The bf16 check holds the kernels' forward to the plain attention's by
#: their distance from the f32 logits (activations in f32 on the same bf16
#: weights: bf16 -> f32 is exact), with the MoE routing pinned to the f32
#: run's decisions in all three.  Unpinned, a router's top-k flips at
#: near-ties between two runs, one flip moves that token's whole MLP
#: output, and over 24 layers the flips compound until the bf16 logits keep
#: about a third of the f32 argmaxes, kernels or not (both recorded); that
#: noise would hide any attention defect.  Pinned, the gate takes the mean
#: absolute error (x BF16_MEAN_FACTOR of the plain run's) and the share of
#: rows whose argmax agrees with f32 (the plain run's less
#: MOE_ARGMAX_SLACK, 13 rows of 256); the largest error is recorded.
MOE_ARGMAX_SLACK = 0.05


class MoERoutes:
    """While active, wraps ``layers.moe_route``: without ``routes`` it
    records each call's decision; with them it hands them back in call
    order instead of routing."""

    def __init__(self, routes=None):
        self.replay = routes is not None
        self.routes = list(routes or [])
        self.calls = 0

    def __enter__(self):
        from repro_torch.models import layers

        self._orig = layers.moe_route

        def pinned(cfg, p, x):
            self.calls += 1
            if self.replay:
                return self.routes[self.calls - 1]
            route = self._orig(cfg, p, x)
            self.routes.append(route)
            return route

        layers.moe_route = pinned
        return self

    def __exit__(self, *exc):
        from repro_torch.models import layers

        layers.moe_route = self._orig

    def drops(self) -> list:
        """Each call's dropped (token, k) pairs per sequence."""
        return [(~r.keep).sum(-1).tolist() for r in self.routes]


def bf16_vs_f32(logits, ref32) -> dict:
    err = (logits.float() - ref32).abs()
    return {"max_abs": float(err.max()), "mean_abs": float(err.mean()),
            "argmax_agreement":
                float((logits.argmax(-1) == ref32.argmax(-1)).double().mean())}


def phase_moe_serve(dev, smi: str) -> dict:
    import dataclasses

    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_decode, rope_cache, ttl_scan
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import forward, layers
    from repro_torch.serve import prefill
    from repro_torch.tree import leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    gates = {}
    args = launch_serve.build_parser().parse_args(MOE_SERVE_ARGS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    fa.reset_launches()
    ttl_scan.ttl_cost_surface.launches = 0
    moe_decode.launches = 0
    rope_cache.launches = 0
    t0 = time.perf_counter()
    res = launch_serve.run(args)
    wall = time.perf_counter() - t0
    route_launches = dict(fa.flash_attention_bshd.route_launches)
    ttl_launches = ttl_scan.ttl_cost_surface.launches
    moe_launches = moe_decode.launches
    rope_launches = rope_cache.launches
    peak = torch.cuda.max_memory_allocated(dev)
    cfg, params, tier = res["cfg"], res["params"], res["tier"]
    param_bytes = sum(t.numel() * t.element_size() for t in leaves(params))
    tier_stats = json.loads(json.dumps(tier.stats))

    prefills = res["hit"].count(False)
    steps = sum(res["decode_steps"])
    want_routes = {"wgmma": cfg.n_layers * prefills,
                   "splitkv": cfg.n_layers * steps, "simt": 0}
    gates["route_launches"] = route_launches == want_routes
    # The routed MoE kernels: a pair a MoE layer in each decode forward,
    # none in prefill (S x top_k above the capacity: the capacity path).
    n_moe = sum(spec.mlp == "moe" for spec in cfg.layers())
    want_moe = 2 * n_moe * steps
    gates["moe_decode_launches"] = moe_launches == want_moe > 0
    # The rope / cache-write kernel: one launch an attention layer in each
    # decode forward, none in prefill.
    want_rope = cfg.n_layers * steps
    gates["rope_cache_launches"] = rope_launches == want_rope > 0
    gates["three_misses_three_hits"] = res["hit"] == [False] * 3 + [True] * 3
    tokens = torch.stack(res["tokens"])
    gates["tokens"] = (tuple(tokens.shape) == (args.requests, args.batch,
                                               args.gen)
                       and bool(((tokens >= 0) & (tokens < cfg.vocab)).all()))
    prefill_s = [x for x in res["prefill_s"] if x is not None]
    decode_s = sum(res["decode_s"])
    n_tok = args.requests * args.batch * args.gen

    # The tier's caches against a fresh prefill of each prompt, bit for
    # bit; the same prefills count each MoE layer's dropped pairs.
    prompts = launch_serve.make_prompts(cfg, args)
    payload_ok, drops = [], []
    for prompt, blk in zip(prompts[:3], tier.blocks.values()):
        with MoERoutes() as rd, torch.no_grad():
            _lg, fresh, _pos = prefill(cfg, params, prompt.to(dev),
                                       max_len=args.prompt_len + args.gen)
        drops.append(rd.drops())
        stored = blk.payload[0]
        payload_ok.append(all(
            torch.equal(stored[g][n][key], fresh[g][n][key])
            for g in fresh for n in fresh[g] for key in fresh[g][n]))
        del fresh
    gates["tier_caches_bit_equal"] = all(payload_ok)
    reuse_agree = float(torch.stack([
        (tokens[i] == tokens[i + 3]).double().mean() for i in range(3)]).mean())
    cap = max(int(cfg.moe.capacity_factor * cfg.moe.top_k * args.prompt_len
                  / cfg.moe.n_routed), min(8, args.prompt_len * cfg.moe.top_k))

    # A hit request traced: where the card's time goes in decode.
    prof = device_profile(lambda: launch_serve.serve(
        cfg, params, prompts[:1], args.gen, tier, dev))
    if "ops" in prof:
        prof["ops"] = dict(sorted(prof["ops"].items(),
                                  key=lambda kv: -kv[1]["count"]
                                  * kv[1]["mean_us"])[:20])
    tier.blocks.clear()
    del res
    torch.cuda.empty_cache()

    # Kernels against plain attention, bf16, at full width and depth; the
    # f32 reference runs f32 activations on the same bf16 weights.
    toks = torch.randint(0, cfg.vocab, (1, MOE_GATE_LEN),
                         generator=torch.Generator().manual_seed(12)).to(dev)
    cfg32 = dataclasses.replace(cfg, act_dtype="float32")
    kernel_attn = layers.flash_attention_bshd
    with torch.no_grad(), MoERoutes() as pin:
        lp = forward(cfg32, params, toks, plain_attention=True)[0]

    def bf16_forward(plain=False, routes=None, cut_layer=None):
        """bf16 logits (routing pinned to ``routes`` if given) and layer
        0's attention held to the plain version on its own inputs
        (``layer0_compare``); the last 64 keys cut from layer
        ``cut_layer``'s call."""
        seen, calls = [], [0]

        def attn(q, k, v, causal, q_offset, scale=None, **masks):
            i = calls[0]
            calls[0] += 1
            cut = slice(None, -64 if i == cut_layer else None)
            out = kernel_attn(q, k[:, cut], v[:, cut], causal=causal,
                              q_offset=q_offset, scale=scale, **masks)
            if i == 0:
                row = layer0_compare(out, q, k, v, causal, q_offset, scale,
                                     **masks)
                row["qkv_std"] = [float(t.float().std()) for t in (q, k, v)]
                seen.append(row)
            return out

        layers.flash_attention_bshd = attn
        try:
            with torch.no_grad(), MoERoutes(routes):
                logits = forward(cfg, params, toks,
                                 plain_attention=plain)[0]
        finally:
            layers.flash_attention_bshd = kernel_attn
        return logits, (seen[0] if seen else None)

    fa.reset_launches()
    lk16, layer0 = bf16_forward(routes=pin.routes)
    bf16_routes = dict(fa.flash_attention_bshd.route_launches)
    lc16, layer0_control = bf16_forward(routes=pin.routes, cut_layer=0)
    lp16, _ = bf16_forward(plain=True, routes=pin.routes)
    e_k, e_p, e_c = (bf16_vs_f32(x, lp) for x in (lk16, lp16, lc16))
    unpinned = {"kernel_vs_f32": bf16_vs_f32(bf16_forward()[0], lp),
                "plain_vs_f32": bf16_vs_f32(bf16_forward(plain=True)[0], lp)}
    torch.cuda.synchronize()

    def within(e):
        return (e["mean_abs"] <= BF16_MEAN_FACTOR * e_p["mean_abs"]
                and e["argmax_agreement"]
                >= e_p["argmax_agreement"] - MOE_ARGMAX_SLACK)

    gates["bf16_routes"] = bf16_routes == {"wgmma": cfg.n_layers,
                                           "splitkv": 0, "simt": 0}
    gates["layer0_attention"] = layer0["ok"]
    gates["bf16_logits"] = bool(torch.isfinite(lk16).all()) and within(e_k)
    gates["control_caught"] = not (within(e_c) and layer0_control["ok"])
    del lk16, lp16, lc16, lp, pin

    # The f32 gate on simt, cut to MOE_F32_LAYERS layers (views of the
    # stacked weights; f32 activations).
    cfg2 = dataclasses.replace(cfg32, n_layers=MOE_F32_LAYERS)
    p2 = dict(params, blocks={"pos0": tree_slice(params["blocks"]["pos0"],
                                                 MOE_F32_LAYERS)})
    fa.reset_launches()
    with torch.no_grad():
        lk = forward(cfg2, p2, toks)[0]
        simt_launches = fa.flash_attention_bshd.route_launches["simt"]
        lp2 = forward(cfg2, p2, toks, plain_attention=True)[0]
    torch.cuda.synchronize()
    diff, scale = float((lk - lp2).abs().max()), float(lp2.abs().max())
    gates["f32_simt"] = (bool(torch.isfinite(lk).all())
                         and diff <= GATE_REL * scale
                         and simt_launches == MOE_F32_LAYERS)
    f32_gate = {"layers": MOE_F32_LAYERS, "batch": 1, "seq": MOE_GATE_LEN,
                "simt_launches": simt_launches, "max_abs_diff": diff,
                "max_abs_logit": scale, "limit": GATE_REL * scale,
                "argmax_agreement":
                    float((lk.argmax(-1) == lp2.argmax(-1)).double().mean())}
    del params, p2, lk, lp2
    torch.cuda.empty_cache()

    ok = all(gates.values())
    emit("moe_serve", ok=ok, nvidia_smi=smi, gates=gates, args=MOE_SERVE_ARGS,
         arch=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
         heads=[cfg.n_heads, cfg.n_kv_heads], head_dim=cfg.resolved_head_dim,
         experts=[cfg.moe.n_routed, cfg.moe.top_k, cfg.moe.n_shared,
                  cfg.moe.d_ff_expert], vocab=cfg.vocab,
         params=cfg.param_count(), param_bytes=param_bytes,
         prefills=prefills, decode_steps=steps,
         route_launches=route_launches, route_launches_expected=want_routes,
         moe_decode_launches=moe_launches,
         moe_decode_launches_expected=want_moe,
         rope_cache_launches=rope_launches,
         rope_cache_launches_expected=want_rope,
         ttl_scan_launches=ttl_launches,
         prefill_ms=[1e3 * x for x in prefill_s],
         decode_ms_per_step=1e3 * decode_s / steps,
         tokens_per_s=n_tok / (sum(prefill_s) + decode_s), wall_s=wall,
         peak_memory_bytes=peak, tier_stats=tier_stats,
         tier_payload_unchanged=payload_ok,
         reused_prefix_token_agreement=reuse_agree,
         moe_prefill_capacity=cap,
         moe_prefill_drops={
             "per_prompt_layer_sequence": drops,
             "per_layer_total": [sum(sum(c[i]) for c in drops)
                                 for i in range(cfg.n_layers)],
             "pairs_per_prompt_layer": args.batch * args.prompt_len
             * cfg.moe.top_k},
         traced_hit_request=prof,
         kernel_vs_plain={
             "batch": 1, "seq": MOE_GATE_LEN, "route_launches": bf16_routes,
             "routing": "pinned to the f32 run's", "layer0_attention": layer0,
             "kernel_vs_f32": e_k, "plain_vs_f32": e_p,
             "limits": {"mean_abs": BF16_MEAN_FACTOR * e_p["mean_abs"],
                        "argmax_agreement":
                            e_p["argmax_agreement"] - MOE_ARGMAX_SLACK},
             "control": {"defect": "the last 64 keys left out of layer 0's "
                                   "attention call",
                         "vs_f32": e_c, "caught_by_logits": not within(e_c),
                         "layer0_attention": layer0_control},
             "unpinned (recorded)": unpinned},
         f32_gate=f32_gate)
    if not ok:
        raise SystemExit("MoE serving path check failed: "
                         + ", ".join(k for k, v in gates.items() if not v))
    return {"routes": route_launches, "simt_gate": simt_launches,
            "moe_decode": moe_launches, "rope_cache": rope_launches}


def tree_slice(tree, n: int):
    """The first ``n`` layers of a stacked tree (views)."""
    from repro_torch.tree import tree_map

    return tree_map(lambda t: t[:n], tree)


# -- gemma3-4b served: local and global layers, ring caches --------------------

GEMMA_SERVE_ARGS = ["--arch", "gemma3-4b", "--no-reduced", "--requests", "6",
                    "--batch", "4", "--prompt-len", "2048", "--gen", "32",
                    "--seed", "0", "--device", "cuda"]
#: The bf16 check's sequence: past the 1,024-key window, so every local
#: layer's window masks keys in the rows past it (layer 0 among them).
GEMMA_GATE_LEN = 2048


def phase_gemma_serve(dev, smi: str) -> dict:
    """gemma3-4b through ``launch.serve`` at full width and depth (34
    layers, d 2560, 8 / 4 heads of 256, a 1,024-key window on 29 layers,
    vocab 262,144; bf16, seeded weights at the reference's fan-in): 2,048-
    token prompts, so the window masks half of each local prefill's keys,
    and 32 generated tokens on 1,024-slot rings that wrap.  Every prefill
    call on ``wgmma`` and every decode call on ``splitkv`` at D 256; the
    tier's caches bit-equal to fresh prefills; a traced hit; bf16 logits
    through the kernels against the f32 plain run's as the plain bf16 run's
    are, layer 0 (a local layer) within 2^-5 of each row's largest value of
    the plain version on q rounded as the kernel rounds it, at positions
    past the window, and a control (every window one key narrower) that
    must be caught."""
    import dataclasses

    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rope_cache, ttl_scan
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import forward, layers
    from repro_torch.serve import prefill
    from repro_torch.tree import leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    gates = {}
    args = launch_serve.build_parser().parse_args(GEMMA_SERVE_ARGS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    kernel_attn = layers.flash_attention_bshd
    calls = []          # (Sq, Skv, causal, window, kv_len) of every call

    def recorded(q, k, v, **kw):
        calls.append((q.shape[1], k.shape[1], kw.get("causal"),
                      kw.get("window"), kw.get("kv_len")))
        return kernel_attn(q, k, v, **kw)

    fa.reset_launches()
    ttl_scan.ttl_cost_surface.launches = 0
    rope_cache.launches = 0
    layers.flash_attention_bshd = recorded
    try:
        t0 = time.perf_counter()
        res = launch_serve.run(args)
        wall = time.perf_counter() - t0
    finally:
        layers.flash_attention_bshd = kernel_attn
    route_launches = dict(fa.flash_attention_bshd.route_launches)
    ttl_launches = ttl_scan.ttl_cost_surface.launches
    rope_launches = rope_cache.launches
    peak = torch.cuda.max_memory_allocated(dev)
    cfg, params, tier = res["cfg"], res["params"], res["tier"]
    tier_stats = json.loads(json.dumps(tier.stats))

    prefills = res["hit"].count(False)
    steps = sum(res["decode_steps"])
    n_local = sum(s.window is not None for s in cfg.layers())
    window = next(s.window for s in cfg.layers() if s.window is not None)
    want_routes = {"wgmma": cfg.n_layers * prefills,
                   "splitkv": cfg.n_layers * steps, "simt": 0}
    gates["route_launches"] = route_launches == want_routes
    # Ring and global decodes alike: one rope / cache-write launch a layer.
    gates["rope_cache_launches"] = rope_launches == cfg.n_layers * steps > 0
    gates["three_misses_three_hits"] = res["hit"] == [False] * 3 + [True] * 3
    tokens = torch.stack(res["tokens"])
    gates["tokens"] = (tuple(tokens.shape) == (args.requests, args.batch,
                                               args.gen)
                       and bool(((tokens >= 0) & (tokens < cfg.vocab)).all()))
    pre = [c for c in calls if c[0] == args.prompt_len]
    dec = [c for c in calls if c[0] == 1]
    ring = [c for c in dec if c[1] == window]
    glob = [c for c in dec if c[1] != window]
    calls_seen = {
        "prefill_windowed": sum(c[3] == window for c in pre),
        "prefill_global": sum(c[3] is None for c in pre),
        "decode_ring": len(ring), "decode_global": len(glob),
        "ring_kv_len": sorted({c[4] for c in ring}),
        "global_kv_len_range": [min((c[4] for c in glob), default=None),
                                max((c[4] for c in glob), default=None)],
        "global_slots": sorted({c[1] for c in glob})}
    # The window bites: every local prefill call attends a 2,048-key
    # prompt through its 1,024-key window.  The rings wrap: every decode
    # position is past 1,024, each local call reads its full ring
    # (kv_len = 1,024 slots) and each global call its filled slots.
    gates["window_bites_in_prefill"] = (
        calls_seen["prefill_windowed"] == n_local * prefills
        and args.prompt_len > window and all(c[2] for c in pre))
    gates["rings_wrap_in_decode"] = (
        len(ring) == n_local * steps and calls_seen["ring_kv_len"] == [window]
        and len(glob) == (cfg.n_layers - n_local) * steps
        and all(c[4] <= c[1] and not c[2] for c in dec)
        and args.prompt_len > window)
    prefill_s = [x for x in res["prefill_s"] if x is not None]
    decode_s = sum(res["decode_s"])
    n_tok = args.requests * args.batch * args.gen

    # The tier's caches against a fresh prefill of each prompt, bit for bit.
    prompts = launch_serve.make_prompts(cfg, args)
    payload_ok = []
    for prompt, blk in zip(prompts[:3], tier.blocks.values()):
        with torch.no_grad():
            _lg, fresh, _pos = prefill(cfg, params, prompt.to(dev),
                                       max_len=args.prompt_len + args.gen)
        stored = blk.payload[0]
        payload_ok.append(all(
            torch.equal(stored[g][n][key], fresh[g][n][key])
            for g in fresh for n in fresh[g] for key in fresh[g][n]))
        del fresh, _lg
    gates["tier_caches_bit_equal"] = all(payload_ok)
    reuse_agree = float(torch.stack([
        (tokens[i] == tokens[i + 3]).double().mean() for i in range(3)]).mean())

    # A hit request traced: where the card's time goes in decode.
    prof = device_profile(lambda: launch_serve.serve(
        cfg, params, prompts[:1], args.gen, tier, dev))
    if "ops" in prof:
        prof["ops"] = dict(sorted(prof["ops"].items(),
                                  key=lambda kv: -kv[1]["count"]
                                  * kv[1]["mean_us"])[:20])
    tier.blocks.clear()
    del res
    torch.cuda.empty_cache()

    # Kernels against plain attention in bf16 at full width and depth, held
    # to f32 activations on the same bf16 weights (bf16 -> f32 is exact).
    toks = torch.randint(0, cfg.vocab, (1, GEMMA_GATE_LEN),
                         generator=torch.Generator().manual_seed(12)).to(dev)
    cfg32 = dataclasses.replace(cfg, act_dtype="float32")
    with torch.no_grad():
        lp = forward(cfg32, params, toks, plain_attention=True)[0]

    def bf16_forward(plain=False, narrower=0):
        """bf16 logits, and layer 0's attention held to the plain version
        with the layer's true window (``layer0_compare``); every window
        ``narrower`` keys narrower in the kernels' calls."""
        seen = []

        def attn(q, k, v, causal, q_offset, scale=None, window=None,
                 kv_len=None):
            got_window = None if window is None else window - narrower
            out = kernel_attn(q, k, v, causal=causal, q_offset=q_offset,
                              scale=scale, window=got_window, kv_len=kv_len)
            if not seen:
                row = layer0_compare(out, q, k, v, causal, q_offset, scale,
                                     window=window, kv_len=kv_len)
                row["window"] = window
                row["qkv_std"] = [float(t.float().std()) for t in (q, k, v)]
                seen.append(row)
            return out

        layers.flash_attention_bshd = attn
        try:
            with torch.no_grad():
                logits = forward(cfg, params, toks, plain_attention=plain)[0]
        finally:
            layers.flash_attention_bshd = kernel_attn
        return logits, (seen[0] if seen else None)

    fa.reset_launches()
    lk16, layer0 = bf16_forward()
    bf16_routes = dict(fa.flash_attention_bshd.route_launches)
    lc16, layer0_control = bf16_forward(narrower=1)
    lp16, _ = bf16_forward(plain=True)
    torch.cuda.synchronize()

    def vs_f32(logits):
        err = (logits.float() - lp).abs()
        return {"max_abs": float(err.max()), "mean_abs": float(err.mean()),
                "argmax_agreement":
                    float((logits.argmax(-1) == lp.argmax(-1)).double().mean())}

    e_k, e_p, e_c = vs_f32(lk16), vs_f32(lp16), vs_f32(lc16)
    limits = {"max_abs": BF16_MAX_FACTOR * e_p["max_abs"],
              "mean_abs": BF16_MEAN_FACTOR * e_p["mean_abs"]}

    def within(e):
        return all(e[key] <= limits[key] for key in limits)

    gates["bf16_routes"] = bf16_routes == {"wgmma": cfg.n_layers,
                                           "splitkv": 0, "simt": 0}
    gates["layer0_attention"] = layer0["ok"] and layer0["window"] == window
    gates["bf16_logits"] = bool(torch.isfinite(lk16).all()) and within(e_k)
    gates["control_caught"] = not (within(e_c) and layer0_control["ok"])
    param_bytes = sum(t.numel() * t.element_size() for t in leaves(params))
    del lk16, lp16, lc16, lp, params
    torch.cuda.empty_cache()

    ok = all(gates.values())
    emit("gemma_serve", ok=ok, nvidia_smi=smi, gates=gates,
         args=GEMMA_SERVE_ARGS, arch=cfg.name, layers=cfg.n_layers,
         local_layers=n_local, window=window, d_model=cfg.d_model,
         heads=[cfg.n_heads, cfg.n_kv_heads],
         head_dim=cfg.resolved_head_dim, vocab=cfg.vocab,
         params=cfg.param_count(), param_bytes=param_bytes,
         prefills=prefills, decode_steps=steps,
         route_launches=route_launches, route_launches_expected=want_routes,
         flash_calls=calls_seen, ttl_scan_launches=ttl_launches,
         rope_cache_launches=rope_launches,
         prefill_ms=[1e3 * x for x in prefill_s],
         decode_ms_per_step=1e3 * decode_s / steps,
         tokens_per_s=n_tok / (sum(prefill_s) + decode_s), wall_s=wall,
         peak_memory_bytes=peak, tier_stats=tier_stats,
         tier_payload_unchanged=payload_ok,
         reused_prefix_token_agreement=reuse_agree,
         traced_hit_request=prof,
         kernel_vs_plain={
             "batch": 1, "seq": GEMMA_GATE_LEN, "route_launches": bf16_routes,
             "layer0_attention": layer0, "kernel_vs_f32": e_k,
             "plain_vs_f32": e_p, "limits": limits,
             "control": {"defect": "every window one key narrower in the "
                                   "kernels' calls",
                         "vs_f32": e_c, "caught_by_logits": not within(e_c),
                         "layer0_attention": layer0_control}})
    if not ok:
        raise SystemExit("gemma3-4b serving path check failed: "
                         + ", ".join(k for k, v in gates.items() if not v))
    return {"routes": route_launches, "ttl_launches": ttl_launches,
            "rope_cache": rope_launches}


# -- the other mixers: MLA, Mamba, RWKV6 ---------------------------------------

#: (arch, layers kept).  deepseek keeps its dense prefix layer and 2 MLA /
#: MoE layers; its MLA prefill (Dk 192, Dv 128) runs on the D 192 wgmma
#: kernel, V zero-padded to 192, held to its plain-attention run
#: (``mla_vs_plain``).  jamba keeps one repeat of its 8-layer pattern (62.1 B
#: parameters do not fit one card); rwkv6 runs at full depth.
#: nemotron-4-340b keeps 2 of its 96 layers at full width (d 18,432, 96 / 8
#: heads of 192, squared-ReLU MLP of 73,728; 16.3 B parameters, 32.6 GB in
#: bf16, ~45 GB at the init's f32 draw of the stacked MLP leaf): its group
#: of 12 puts 10 positions in a 128-row wgmma item and leaves 8 rows spare.
#: Weights are drawn ``per_layer`` (see ``init_params``): with the
#: reference's fan-in (the layer count) one or two repeats leave std-1
#: weights, and deepseek's bf16 logits came out all zero (the final norm's
#: fp32 square overflows).
MIXER_RUNS = [("deepseek-v2-lite-16b", 3),
              ("jamba-v0.1-52b", 8),
              ("rwkv6-3b", 32),
              ("nemotron-4-340b", 2)]
MIXER_BATCH, MIXER_PROMPT, MIXER_STEPS = 2, 1024, 8
#: A decode step's logits against a full forward of the extended sequence,
#: with f32 activations on the same bf16 weights (exact), on the first
#: MIXER_CHECK_LAYERS layers: each held row's largest error at most
#: MIXER_TOL of its largest |logit|.  A row is held where the two compute
#: the same function: every MoE layer dropped as many of that row's pairs
#: in the full forward as in the prefill (the new token kept, the prefix's
#: drops unchanged), and for RWKV6 the step opens a chunk (inside one, the
#: chunked forward rounds its intra-chunk scores to bf16, as the reference
#: does, and the decode step does not).  The depth cut: a random-init RWKV6
#: stack amplifies the two paths' rounding layer by layer (its token shift
#: subtracts nearly equal hidden states), smoothly, to ~1 % after 8 layers
#: and past 50 % after 32 (``scripts/rwkv_decode_drift.py``).
MIXER_TOL = 2.0 ** -4
MIXER_CHECK_LAYERS = 8
#: After the bf16 decode steps, the first layer's caches (written in place
#: into views of the stack) against those of a bf16 prefill of the whole
#: sequence, whose layer-0 inputs are the same: each leaf within this share
#: of its largest |value|.  A cache left stale by a step is off by O(1).
LAYER0_CACHE_TOL = 2.0 ** -5
#: The reduced configs, f32, card against the port on the CPU.
REDUCED_TOL = 1e-4
REDUCED_ARCHS = ("qwen2-moe-a2.7b", "deepseek-v2-lite-16b", "jamba-v0.1-52b",
                 "rwkv6-3b", "gemma3-4b")


def decode_steps(cfg, params, toks):
    """Prefill ``MIXER_PROMPT`` tokens (each MoE call's drops per row
    counted), grow the caches, decode ``MIXER_STEPS`` more; returns
    (prefill logits, each step's last logits, the caches, per-call drops,
    prefill s, decode s, the MLA decode kernels' launches and the rope /
    cache-write kernel's, each in the prefill and in the decode steps)."""
    import torch
    from repro_torch.kernels import mla_decode, rope_cache
    from repro_torch.models import forward
    from repro_torch.serve import grow_cache

    mla_decode.launches = 0
    rope_cache.launches = 0
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with MoERoutes() as rd:
            logits, caches, _ = forward(cfg, params, toks[:, :MIXER_PROMPT],
                                        mode="prefill")
        caches = grow_cache(cfg, caches, MIXER_PROMPT + MIXER_STEPS)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        mla_prefill, rope_prefill = mla_decode.launches, rope_cache.launches
        dec = []
        for j in range(MIXER_STEPS):
            pos = MIXER_PROMPT + j
            dec.append(forward(cfg, params, toks[:, pos:pos + 1],
                               mode="decode", caches=caches, pos=pos)[0][:, -1])
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    mla = {"prefill": mla_prefill, "decode": mla_decode.launches - mla_prefill}
    rope = {"prefill": rope_prefill,
            "decode": rope_cache.launches - rope_prefill}
    return logits, dec, caches, rd.drops(), t1 - t0, t2 - t1, mla, rope


def layer0_caches(caches):
    """The first layer's cache leaves (a prefix layer's, or repeat 0 of
    pattern position 0)."""
    layer = (caches["prefix"]["layer0"] if caches["prefix"]
             else {k: v[0] for k, v in caches["blocks"]["pos0"].items()})
    return layer


def mla_vs_plain(cfg, params, toks) -> dict:
    """The MLA prefill on the kernel against its plain-attention run (the
    control): layer 0's MLA call (V zero-padded to Dk) within 2^-5 of each
    row's largest value of the plain version on q rounded as the kernel
    rounds it; the same call with its last 64 keys left out, which must
    fail that; the bf16 prefill logits' distance from the plain run's
    (recorded: bf16 MoE routing flips at near-ties)."""
    import torch
    from repro_torch.models import forward, layers

    kernel_attn = layers.flash_attention_bshd

    def run(cut: bool):
        seen = []

        def attn(q, k, v, causal, q_offset, scale=None, **masks):
            n = -64 if cut and not seen else None
            out = kernel_attn(q, k[:, :n], v[:, :n], causal=causal,
                              q_offset=q_offset, scale=scale, **masks)
            if not seen:
                seen.append(layer0_compare(out, q, k, v, causal, q_offset,
                                           scale, **masks))
                seen[0]["dims"] = [q.shape[-1], v.shape[-1]]
            return out

        layers.flash_attention_bshd = attn
        try:
            with torch.no_grad():
                logits = forward(cfg, params, toks, mode="prefill")[0]
        finally:
            layers.flash_attention_bshd = kernel_attn
        return logits, seen[0]

    lk, row = run(False)
    _lc, control = run(True)
    with torch.no_grad():
        lp = forward(cfg, params, toks, mode="prefill",
                     plain_attention=True)[0]
    err = float((lk.float() - lp.float()).abs().max())
    return {"layer0_attention": row,
            "control": {"defect": "the last 64 keys left out of layer 0's "
                                  "MLA call", **control},
            "prefill_logits_vs_plain (recorded)": {
                "max_abs": err, "scale": float(lp.float().abs().max()),
                "argmax_agreement": float((lk.argmax(-1) == lp.argmax(-1))
                                          .double().mean())}}


def mixer_run(arch: str, n_layers: int, dev) -> tuple:
    """The bf16 prefill and decode steps (times, launches, finite, layer-0
    caches against a prefill of the whole sequence), then the same in f32
    activations, each step's logits held to a full forward of the
    extended sequence where the two compute the same function."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import forward, init_params

    cfg = dataclasses.replace(get_config(arch), n_layers=n_layers)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                         per_layer=True)
    toks = torch.randint(0, cfg.vocab, (MIXER_BATCH, MIXER_PROMPT + MIXER_STEPS),
                         generator=torch.Generator().manual_seed(7)).to(dev)
    n_attn = sum(s.mixer in ("attn", "swa") for s in cfg.layers())
    n_mla = sum(s.mixer == "mla" for s in cfg.layers())
    n = MIXER_PROMPT + MIXER_STEPS

    # bf16, the main path: prefill and decode on the kernels (MLA's decode
    # in latent space on the MLA decode pair, two launches a layer a step).
    fa.reset_launches()
    (logits, dec, caches, drops16, prefill_s, decode_s, mla16,
     rope16) = decode_steps(cfg, params, toks)
    routes = dict(fa.flash_attention_bshd.route_launches)
    finite = bool(torch.isfinite(logits).all()) and all(
        bool(torch.isfinite(d).all()) for d in dec)
    peak = torch.cuda.max_memory_allocated(dev)
    with torch.no_grad():
        whole = forward(cfg, params, toks, mode="prefill")[1]
    cache_err = {}
    for key, got in layer0_caches(caches).items():
        want = layer0_caches(whole)[key]
        if key in ("ckv", "krope"):        # the rows the decode steps wrote
            got, want = got[:, MIXER_PROMPT:n], want[:, MIXER_PROMPT:n]
        cache_err[key] = float((got.float() - want.float()).abs().max()) / max(
            float(want.float().abs().max()), 1e-30)
    del logits, caches, whole
    mla = mla_vs_plain(cfg, params, toks[:, :MIXER_PROMPT]) if n_mla else None

    # f32 activations on the same weights, the first MIXER_CHECK_LAYERS
    # layers: decode against full forwards.
    n_chk = min(n_layers, MIXER_CHECK_LAYERS)
    reps = (n_chk - len(cfg.prefix)) // len(cfg.pattern)
    cfg32 = dataclasses.replace(cfg, act_dtype="float32", n_layers=n_chk)
    p32 = dict(params, blocks={k: tree_slice(v, reps)
                               for k, v in params["blocks"].items()})
    _lg, dec32, _c, drops32, _ps, _ds, mla32, rope32 = decode_steps(
        cfg32, p32, toks)
    del _lg, _c
    steps = []
    for j in range(MIXER_STEPS):
        with torch.no_grad(), MoERoutes() as rd:
            full = forward(cfg32, p32,
                           toks[:, :MIXER_PROMPT + j + 1])[0][:, -1]
        full_drops = rd.drops()
        chunk_start = (cfg.rwkv is None
                       or (MIXER_PROMPT + j) % cfg.rwkv.chunk == 0)
        rows = []
        for b in range(MIXER_BATCH):
            err = float((dec32[j][b] - full[b]).abs().max())
            scale = float(full[b].abs().max())
            held = chunk_start and all(f[b] == p[b] for f, p in
                                       zip(full_drops, drops32))
            rows.append({"rel_err": err / max(scale, 1e-30), "scale": scale,
                         "held": held,
                         "new_token_or_prefix_drops": sum(f[b] - p[b] for f, p
                                                          in zip(full_drops,
                                                                 drops32)),
                         "argmax_agree": bool(dec32[j][b].argmax()
                                              == full[b].argmax()),
                         "ok": (not held) or err <= MIXER_TOL * scale})
        steps.append(rows)
        finite = finite and bool(torch.isfinite(full).all())
    routes32 = dict(fa.flash_attention_bshd.route_launches)
    want_routes = {"wgmma": n_attn + n_mla, "splitkv": n_attn * MIXER_STEPS,
                   "simt": 0}
    want_mla = {"prefill": 0, "decode": 2 * n_mla * MIXER_STEPS}
    # The rope / cache-write kernel: one launch a GQA layer a decode step
    # (bf16 and f32 alike), none in prefill.
    n_attn32 = sum(s.mixer in ("attn", "swa") for s in cfg32.layers())
    want_rope = {"prefill": 0, "decode": n_attn * MIXER_STEPS}
    want_rope32 = {"prefill": 0, "decode": n_attn32 * MIXER_STEPS}
    gates = {"finite": finite,
             "logits_not_all_zero": all(r["scale"] > 0 for s in steps
                                        for r in s),
             "route_launches": routes == want_routes,
             "mla_decode_launches": mla16 == want_mla,
             "mla_decode_launches_f32": mla32 == {"prefill": 0, "decode": 0},
             "rope_cache_launches": rope16 == want_rope,
             "rope_cache_launches_f32": rope32 == want_rope32,
             "layer0_caches": max(cache_err.values()) <= LAYER0_CACHE_TOL,
             "decode_vs_full_f32": all(r["ok"] for s in steps for r in s)}
    if mla is not None:
        gates["mla_layer0_vs_plain"] = mla["layer0_attention"]["ok"]
        gates["mla_control_caught"] = not mla["control"]["ok"]
    held = [r for s in steps for r in s if r["held"]]
    out = {"arch": arch, "layers": n_layers, "mla_vs_plain": mla,
           "d_model": cfg.d_model, "params": cfg.param_count(),
           "batch": MIXER_BATCH, "prompt": MIXER_PROMPT, "steps": MIXER_STEPS,
           "gates": gates, "route_launches": routes,
           "route_launches_expected": want_routes,
           "mla_decode_launches": mla16,
           "mla_decode_launches_expected": want_mla,
           "rope_cache_launches": {"bf16": rope16, "f32": rope32},
           "rope_cache_launches_expected": {"bf16": want_rope,
                                            "f32": want_rope32},
           "route_launches_after_main_path": {k: routes32[k] - routes[k]
                                        for k in routes},
           "prefill_drops_per_row_bf16": [sum(c[b] for c in drops16)
                                          for b in range(MIXER_BATCH)],
           "prefill_drops_per_row_f32": [sum(c[b] for c in drops32)
                                         for b in range(MIXER_BATCH)],
           "pairs_per_row": MIXER_PROMPT * (cfg.moe.top_k if cfg.moe else 0)
           * sum(s.mlp == "moe" for s in cfg.layers()),
           "layer0_cache_rel_err": cache_err, "f32_check_layers": n_chk,
           "rows_held": len(held), "rows_total": MIXER_STEPS * MIXER_BATCH,
           "max_rel_err_held": max([r["rel_err"] for r in held], default=None),
           "max_rel_err_all": max(r["rel_err"] for s in steps for r in s),
           "argmax_agreement_f32": sum(r["argmax_agree"] for s in steps
                                       for r in s) / (MIXER_STEPS * MIXER_BATCH),
           "steps_f32": steps, "prefill_ms": 1e3 * prefill_s,
           "decode_ms_per_step": 1e3 * decode_s / MIXER_STEPS,
           "peak_memory_bytes": peak}
    del params, p32, dec, dec32
    torch.cuda.empty_cache()
    return out, {**routes, "mla_decode": mla16["decode"],
                 "rope_cache": rope16["decode"] + rope32["decode"]}


def reduced_card_vs_cpu(arch: str, dev) -> tuple:
    """The reduced config in f32 on the card and on the CPU from the same
    parameters (drawn ``per_layer``: at one repeat the reference's fan-in
    leaves std-1 weights and activations of ~1e9, whose rounding the stack
    amplifies past the limit) and tokens: train and prefill logits, three decode steps'
    logits, and the caches after them, each within REDUCED_TOL of its
    scale.  Attention on the card runs on simt (head dim 8 padded to 64,
    MLA's Dk 16 / Dv 8 too; gemma3's 8-key windows in train and prefill,
    its 8-slot rings in decode)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rope_cache
    from repro_torch.models import forward, init_params
    from repro_torch.serve import grow_cache
    from repro_torch.tree import leaves_with_path, tree_map

    cfg = get_config(arch).reduced()
    p_cpu = init_params(torch.Generator().manual_seed(1), cfg, device="cpu",
                        per_layer=True)
    p_dev = tree_map(lambda t: t.to(dev), p_cpu)
    rng = np.random.default_rng(len(arch))
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 19)).astype(np.int64))
    errs = {}

    def run(params, device):
        t = toks.to(device)
        out = {}
        with torch.no_grad():
            out["train"] = forward(cfg, params, t[:, :16])[0]
            lg, caches, _ = forward(cfg, params, t[:, :16], mode="prefill")
            out["prefill"] = lg
            caches = grow_cache(cfg, caches, 24)
            for j in range(3):
                out[f"decode{j}"] = forward(cfg, params, t[:, 16 + j:17 + j],
                                            mode="decode", caches=caches,
                                            pos=16 + j)[0]
        out.update({"cache/" + "/".join(p): x
                    for p, x in leaves_with_path(caches)})
        return out

    fa.reset_launches()
    rope_cache.launches = 0
    got = run(p_dev, dev)
    routes = dict(fa.flash_attention_bshd.route_launches)
    rope_launches = rope_cache.launches
    want = run(p_cpu, torch.device("cpu"))
    for key, w in want.items():
        g = got[key].cpu().float()
        errs[key] = float((g - w.float()).abs().max()) / max(
            float(w.float().abs().max()), 1e-30)
    n_attn = sum(s.mixer in ("attn", "swa") for s in cfg.layers())
    n_mla = sum(s.mixer == "mla" for s in cfg.layers())
    want_routes = {"wgmma": 0, "splitkv": 0, "simt": n_attn * 5 + n_mla * 2}
    # The rope / cache-write kernel: a launch a GQA layer in each of the
    # card's three decode steps (the CPU's run takes its plain version).
    want_rope = n_attn * 3
    ok = (max(errs.values()) <= REDUCED_TOL and routes == want_routes
          and rope_launches == want_rope
          and all(bool(torch.isfinite(x).all()) for x in got.values()))
    return ({"arch": cfg.name, "ok": ok,
             "max_rel_err": max(errs.values()), "rel_err": errs,
             "route_launches": routes, "route_launches_expected": want_routes,
             "rope_cache_launches": rope_launches,
             "rope_cache_launches_expected": want_rope},
            {**routes, "rope_cache": rope_launches})


def phase_mixers(dev, smi: str) -> dict:
    import torch
    from repro_torch.kernels import moe_decode

    torch.backends.cuda.matmul.allow_tf32 = False
    moe_decode.launches = 0
    runs, routes = [], {"wgmma": 0, "splitkv": 0, "simt": 0}
    mla_launches = rope_launches = 0
    for arch, n_layers in MIXER_RUNS:
        row, r = mixer_run(arch, n_layers, dev)
        runs.append(row)
        routes = {k: routes[k] + r[k] for k in routes}
        mla_launches += r["mla_decode"]
        rope_launches += r["rope_cache"]
    reduced = []
    for arch in REDUCED_ARCHS:
        row, r = reduced_card_vs_cpu(arch, dev)
        reduced.append(row)
        routes = {k: routes[k] + r[k] for k in routes}
        rope_launches += r["rope_cache"]

    gates = {r["arch"]: all(r["gates"].values()) for r in runs}
    gates.update({f"reduced {r['arch']}": r["ok"] for r in reduced})
    ok = all(gates.values())
    emit("mixers", ok=ok, nvidia_smi=smi, gates=gates, runs=runs,
         mixer_tol=MIXER_TOL, mixer_check_layers=MIXER_CHECK_LAYERS,
         layer0_cache_tol=LAYER0_CACHE_TOL,
         reduced=reduced, reduced_tol=REDUCED_TOL, route_launches=routes,
         moe_decode_launches=moe_decode.launches,
         mla_decode_launches=mla_launches, rope_cache_launches=rope_launches)
    if not ok:
        raise SystemExit("mixer check failed: "
                         + ", ".join(k for k, v in gates.items() if not v))
    return {**routes, "moe_decode": moe_decode.launches,
            "mla_decode": mla_launches, "rope_cache": rope_launches}

DIST_ARCH = "llama3.2-1b"
PIPE_BATCH, PIPE_SEQ, PIPE_MB = 4, 1024, 4
#: The one-stage pipeline runs the same bf16 blocks on the same rows as the
#: sequential forward, one microbatch of 1 x 1,024 tokens at a time instead
#: of all 4 x 1,024 at once: only the GEMMs' row counts differ, which may
#: change cuBLAS's tiling and so the order of the fp32 sums before each
#: bf16 rounding.  Differences are then a few bf16 ulps of the activations
#: carried through 16 layers, so the logits are held to 2^-5 of their
#: largest magnitude and the argmax to agree on 99 % of the tokens.  The
#: 4-stage numerics (P2P rotations, the reverse pipeline's gradients) are
#: held on the CPU by tests/test_torch_pipeline.py: NCCL takes one rank per
#: card, so four stages need four cards.
PIPE_TOL = 2.0 ** -5
PIPE_ARGMAX = 0.99
#: The dry-run's cells (multi_pod, ["arch:shape", ...]), one process a
#: group, the groups side by side (each cell is one host core's Python
#: work; the train cells are the longest).  The last four groups are the
#: cells the repairs of ROADMAP Queue 3 (k)-(o) opened: a frontend's train
#: step, nemotron-4-340b's memory and the Mamba / RWKV6 scans.
DRYRUN_GROUPS = [
    (False, ["qwen2-moe-a2.7b:train_4k"]),
    (False, ["gemma3-4b:train_4k", "gemma3-4b:decode_32k",
             "hubert-xlarge:train_4k"]),
    (False, ["llama3.2-1b:train_4k", "llama3.2-1b:prefill_32k",
             "llama3.2-1b:decode_32k", "qwen2-moe-a2.7b:decode_32k"]),
    (True, ["llama3.2-1b:train_4k"]),
    (False, ["nemotron-4-340b:train_4k"]),
    (False, ["nemotron-4-340b:prefill_32k"]),
    (False, ["jamba-v0.1-52b:prefill_32k"]),
    (False, ["rwkv6-3b:train_4k"]),
]
CARD_BYTES = 80e9
#: The most one cell's trace may take (its own ``seconds``).  The groups
#: start before the first phase, at the lowest CPU priority, and trace on
#: the host's other cores while the card's phases run.
DRYRUN_TIMEOUT_S = 600
EXAMPLES = [("torch_quickstart.py", []),
            ("torch_multicloud_placement.py", ["--objects", "20",
                                               "--months", "3"]),
            ("torch_s3_proxy_demo.py", []),
            ("torch_serve_decode.py", ["--requests", "6", "--gen", "8"]),
            ("torch_train_100m.py", ["--steps", "4", "--tiny",
                                     "--checkpoint-every", "2",
                                     "--fail-at", "3"])]


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def pipeline_run(dev) -> dict:
    """(a) a one-rank NCCL group and its host mesh; (b) the GPipe schedule
    at one stage against the sequential forward, and its loss's backward."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_config
    from repro_torch.distributed.pipeline import (
        make_pipelined_forward, pipeline_loss_fn, stage_param_sharding)
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import cross_entropy, forward, init_params
    from repro_torch.tree import leaves, unflatten

    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}",
                            world_size=1, rank=0)
    try:
        host = make_host_mesh(device="cuda")
        probe = torch.ones(4, device=dev)
        dist.all_reduce(probe, group=host.get_group("data"))
        stage_mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("stage",))
        cfg = get_config(DIST_ARCH)
        params = init_params(torch.Generator(device=dev).manual_seed(0), cfg)
        gen = torch.Generator(device=dev).manual_seed(1)
        toks = torch.randint(0, cfg.vocab, (PIPE_BATCH, PIPE_SEQ),
                             generator=gen, device=dev)
        labels = torch.randint(0, cfg.vocab, (PIPE_BATCH, PIPE_SEQ),
                               generator=gen, device=dev)
        local = stage_param_sharding(stage_mesh, params, 1)
        fwd = make_pipelined_forward(cfg, stage_mesh, 1, PIPE_MB)
        with torch.no_grad():
            fa.reset_launches()
            pp = fwd(local, toks)
            torch.cuda.synchronize()
            pp_routes = dict(fa.flash_attention_bshd.route_launches)
            fa.reset_launches()
            seq, _, _ = forward(cfg, params, toks, mode="train")
            torch.cuda.synchronize()
            seq_routes = dict(fa.flash_attention_bshd.route_launches)
            ppf, seqf = pp.float(), seq.float()
            rel = float((ppf - seqf).abs().max() / seqf.abs().max())
            agree = float((ppf.argmax(-1) == seqf.argmax(-1)).float().mean())
            finite = bool(torch.isfinite(ppf).all())
            del ppf, seqf, pp, seq
            pp_ms = cuda_ms(lambda: fwd(local, toks), 1, reps=5)
            seq_ms = cuda_ms(lambda: forward(cfg, params, toks,
                                             mode="train"), 1, reps=5)
        flat = [p.detach().requires_grad_(True) for p in leaves(local)]
        loss = pipeline_loss_fn(cfg, stage_mesh, 1, PIPE_MB)(
            unflatten(local, flat), {"inputs": toks, "labels": labels})
        loss.backward()
        pp_loss = float(loss.detach())
        grads = [p.grad for p in flat]
        grads_finite = all(bool(torch.isfinite(g).all()) for g in grads)
        grad_mass = float(sum(g.float().abs().sum() for g in grads))
        del loss, grads, flat
        with torch.no_grad():
            seq_lg, _, _ = forward(cfg, params, toks, mode="train",
                                   plain_attention=True)
            seq_loss = float(cross_entropy(seq_lg, labels))
        loss_rel = abs(pp_loss - seq_loss) / abs(seq_loss)
        del seq_lg, params, local
        torch.cuda.empty_cache()
        layers = cfg.n_layers
        gates = {
            "host_mesh_one_rank": tuple(host.shape) == (1, 1)
            and float(probe[0]) == 1.0,
            "pipeline_finite": finite,
            "pipeline_logits_within_tol": rel <= PIPE_TOL,
            "pipeline_argmax_agree": agree >= PIPE_ARGMAX,
            "pipeline_on_wgmma": pp_routes.get("wgmma") == layers * PIPE_MB
            and seq_routes.get("wgmma") == layers,
            "pipeline_loss_within_bf16": loss_rel <= 2.0 ** -7,
            "pipeline_grads_finite_nonzero": grads_finite and grad_mass > 0,
        }
        return {"gates": gates, "host_mesh": list(host.shape),
                "nccl_all_reduce": float(probe[0]),
                "logits_max_rel": rel, "argmax_agree": agree,
                "pipe_tol": PIPE_TOL, "routes_pipelined": pp_routes,
                "routes_sequential": seq_routes,
                "pipelined_ms": pp_ms, "sequential_ms": seq_ms,
                "loss": pp_loss, "sequential_loss": seq_loss,
                "loss_rel": loss_rel,
                "grad_abs_sum": grad_mass,
                "wgmma_launches": pp_routes.get("wgmma", 0)
                + seq_routes.get("wgmma", 0)}
    finally:
        dist.destroy_process_group()


def start_dryrun() -> list:
    """(c) the dry-run's cells on the fake 256 / 512-rank meshes, on fake
    CUDA tensors: ``python -m repro_torch.launch.dryrun`` in one process a
    group of cells (a mesh is never rebuilt in a process), all started at
    once, niced so the card's phases keep their host core."""
    import os

    env = dict(os.environ, PYTHONPATH=str(SRC))
    OUT.parent.mkdir(parents=True, exist_ok=True)
    procs = []
    for k, (multi_pod, cells) in enumerate(DRYRUN_GROUPS):
        out = OUT.parent / f"dryrun_{k}.json"
        out.unlink(missing_ok=True)
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--device", "cuda", "--out", str(out)]
        cmd += [arg for c in cells for arg in ("--cell", c)]
        cmd += ["--multi-pod"] if multi_pod else []
        procs.append((out, len(cells), time.perf_counter(), subprocess.Popen(
            ["nice", "-n", "19", *cmd], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)))
    return procs


def stop_dryrun(procs) -> None:
    """Kill any dry-run process still running (a phase failed first)."""
    for _out, _n, _t0, proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def finish_dryrun(procs) -> tuple:
    """The cells' results in ``DRYRUN_GROUPS``' order, and their roofline
    rows.  A group gets ``DRYRUN_TIMEOUT_S`` a cell from its start."""
    from repro_torch.launch import roofline

    results = []
    for out, n_cells, t0, proc in procs:
        left = t0 + n_cells * DRYRUN_TIMEOUT_S - time.perf_counter()
        try:
            stdout, stderr = proc.communicate(timeout=max(left, 1.0))
        except subprocess.TimeoutExpired:
            proc.kill()
            stdout, stderr = proc.communicate()
        print(stdout[-3000:], flush=True)
        if not out.exists():
            print(stderr[-4000:], file=sys.stderr)
            raise SystemExit(f"dry-run wrote no results (exit "
                             f"{proc.returncode}): {out.name}")
        results += json.loads(out.read_text())
    return results, roofline.roofline_rows(results)


def run_examples() -> dict:
    """(d) every example on the card at small arguments, in this process
    (their kernel launches counted)."""
    import runpy

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ttl_scan

    out = {}
    for script, extra in EXAMPLES:
        argv = sys.argv
        sys.argv = [script, *extra, "--device", "cuda"]
        fa.reset_launches()
        ttl_scan.ttl_cost_surface.launches = 0
        t0 = time.perf_counter()
        code = 0
        try:
            runpy.run_path(str(ROOT / "examples" / script),
                           run_name="__main__")
        except SystemExit as e:
            code = e.code or 0
        finally:
            sys.argv = argv
        out[script] = {"exit": code, "seconds": time.perf_counter() - t0,
                       "flash_routes": dict(fa.flash_attention_bshd.route_launches),
                       "ttl_scan_launches": ttl_scan.ttl_cost_surface.launches}
    return out


def phase_dist(dev, smi: str, procs) -> dict:
    """Sharding rules, the dry-run (its processes ``procs`` started before
    the first phase), the roofline and the GPipe pipeline, and the examples
    (module docstring)."""
    t0 = time.perf_counter()
    pipe = pipeline_run(dev)
    t1 = time.perf_counter()
    examples = run_examples()           # while the dry-run traces
    t2 = time.perf_counter()
    results, rows = finish_dryrun(procs)
    t3 = time.perf_counter()
    ok_cells = [r for r in results if r["ok"]]
    gates = dict(pipe["gates"])
    gates["dryrun_every_cell_ok"] = len(ok_cells) == sum(
        len(cells) for _, cells in DRYRUN_GROUPS)
    gates["dryrun_bytes_under_card"] = all(
        r["memory"]["total_hbm_bytes"] < CARD_BYTES for r in ok_cells)
    gates["dryrun_each_cell_within_timeout"] = all(
        r["seconds"] <= DRYRUN_TIMEOUT_S for r in results)
    gates["dryrun_collectives"] = all(
        r["hlo"]["collective_bytes"] > 0 for r in ok_cells)
    gates["examples_exit_0"] = all(e["exit"] == 0 for e in examples.values())
    ok = all(gates.values())
    cells = [{"cell": [r["arch"], r["shape"], r["mesh"]], "ok": r["ok"],
              "error": r["error"][:300], "seconds": r["seconds"],
              "microbatches": r["microbatches"],
              "memory": r["memory"],
              "hlo": {k: r["hlo"].get(k) for k in (
                  "flops", "bytes", "collective_bytes",
                  "collective_bytes_by_kind", "peak_bytes", "n_ops")}}
             for r in results]
    emit("dist", ok=ok, nvidia_smi=smi, gates=gates, pipeline=pipe,
         dryrun=cells, roofline=[{k: v for k, v in row.items() if k != "hint"}
                                 for row in rows],
         examples=examples, card_bytes=CARD_BYTES,
         dryrun_timeout_s=DRYRUN_TIMEOUT_S,
         seconds={"pipeline": t1 - t0, "examples": t2 - t1,
                  "dryrun_wait_after_examples": t3 - t2,
                  "dryrun_since_start": t3 - procs[0][2],
                  "phase": t3 - t0})
    if not ok:
        raise SystemExit("dist check failed: "
                         + ", ".join(k for k, v in gates.items() if not v))
    return {"wgmma": pipe["wgmma_launches"],
            "examples_flash": examples["torch_serve_decode.py"]["flash_routes"],
            "examples_ttl": sum(e["ttl_scan_launches"]
                                for e in examples.values())}


def moe_decode_entry(rows: dict, serve_launches: int,
                     mixers_launches: int) -> dict:
    """The summary's row of the routed MoE kernel pair: qwen2-moe's B 4
    decode call, the other two configs beside it."""
    q = rows["qwen2-moe-a2.7b"]
    keys = ("shape", "distinct_experts", "normwise_err", "normwise_err_tile32",
            "ms", "device_us", "up_tile32_device_us", "plain_ms",
            "capacity_ms", "capacity_device_us", "bound_ms",
            "share_of_bound_device")
    return {
        "name": "moe_decode", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/moe_decode.cu",
        "kernels": list(MOE_KERNELS),
        "replaces": None,
        "replaces_note": "no Pallas kernel: the JAX package's apply_moe is "
                         "plain jnp; in decode its capacity buffer is almost "
                         "all zeros",
        "launches": serve_launches + mixers_launches,
        "launches_by_path": {"moe_serve": serve_launches,
                             "mixers": mixers_launches},
        "max_normwise_err": max(max(r["normwise_err"],
                                    r["normwise_err_tile32"])
                                for r in rows.values()),
        **{k: q[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                             "device_us", "share_of_bound_device",
                             "capacity_ms", "capacity_device_us")},
        "library_ms": None,
        "library_note": "no single PyTorch call computes the routed pairs; "
                        "the capacity path it replaces is the yardstick "
                        "(capacity_ms)",
        "shape": q["shape"], "batch": q["batch"],
        "call": "one layer, one decode step, bf16, router-like routes",
        "deepseek_v2_lite": {k: rows["deepseek-v2-lite-16b"][k] for k in keys},
        "jamba": {k: rows["jamba-v0.1-52b"][k] for k in keys},
    }


def mla_decode_entry(rows: dict, mixers_launches: int) -> dict:
    """The summary's row of the MLA decode kernel pair: the cell's first
    decode step (kv_len 16,385), its last beside it."""
    first, last = (rows[k] for k in MLA_DECODE_KV_LENS)
    keys = ("kv_len", "splits", "max_abs_err", "ms", "device_us", "plain_ms",
            "einsum_all_slots_ms", "library_ms", "library_bound_ms",
            "bound_ms", "share_of_bound_device")
    return {
        "name": "mla_decode", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mla_decode.cu",
        "kernels": list(MLA_KERNELS),
        "replaces": None,
        "replaces_note": "no Pallas kernel: the JAX package's apply_mla "
                         "decode is plain jnp over every max_len slot in fp32 "
                         "(einsum_all_slots_ms)",
        "launches": mixers_launches,
        "launches_by_path": {"mixers": mixers_launches},
        "max_abs_err": max(max(r["max_abs_err"].values())
                           for r in rows.values()),
        **{k: first[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                 "device_us", "share_of_bound_device",
                                 "library_ms", "library_bound_ms",
                                 "einsum_all_slots_ms")},
        "library_note": "scaled_dot_product_attention over the per-head K / "
                        "V decompressed from the same rows (K = [ckv w_uk ; "
                        "krope], V = ckv w_uv), timed alone",
        "shape": first["shape"], "batch": first["batch"],
        "kv_len": first["kv_len"],
        "call": "one MLA layer, one decode step, bf16",
        "last_step": {k: last[k] for k in keys},
    }


def rope_cache_entry(timing: dict, by_path: dict) -> dict:
    """The summary's row of the rope / cache-write kernel: qwen2-moe's B 4
    decode call; ``by_path`` its launches in each serving phase."""
    return {
        "name": "rope_cache", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rope_cache.cu",
        "kernels": list(ROPE_KERNELS),
        "replaces": None,
        "replaces_note": "no Pallas kernel: the JAX package's apply_attn "
                         "rotates q and k and writes the cache with plain jnp",
        "launches": sum(by_path.values()),
        "launches_by_path": by_path,
        **{k: timing[k] for k in ("max_abs_err", "max_differing_elements")},
        **{k: timing[k] for k in ("ms", "bound_ms", "bound_by", "device_us",
                                  "share_of_bound_device", "host_us_a_call",
                                  "replaced_ms", "replaced_device_us",
                                  "replaced_host_us_a_call")},
        "plain_ms": timing["replaced_ms"],
        "library_ms": None,
        "library_note": "no single PyTorch call rotates and writes the "
                        "cache; the ops it replaces are the yardstick "
                        "(replaced_ms)",
        "shape": timing["shape"], "call": "one attention layer, one decode "
                                          "step, bf16",
    }


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
    from repro_torch.kernels import (flash_attention, mla_decode, moe_decode,
                                     rope_cache, ttl_scan)
    from repro_torch.kernels.ops import resolve_device

    dev = resolve_device("cuda")
    smi = nvidia_smi()
    t0 = time.perf_counter()
    libraries = (ttl_scan.LIBRARY, *flash_attention.LIBRARIES.values(),
                 moe_decode.LIBRARY, mla_decode.LIBRARY, rope_cache.LIBRARY)
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

    procs = start_dryrun()            # host-only work, beside the phases
    try:
        kern = phase_kernels(dev)
        phase_decisions(dev)
        launches = phase_replay(dev)
        live = phase_live(dev)
        flash = phase_flash(dev)
        moe_kern = phase_moe_decode(dev)
        mla_kern = phase_mla_decode(dev)
        rope_kern = phase_rope_cache(dev)
        serve = phase_serve(dev)
        train = phase_train(dev, smi)
        encode = phase_encode(dev, smi)
        moe = phase_moe_serve(dev, smi)
        gemma = phase_gemma_serve(dev, smi)
        mixers = phase_mixers(dev, smi)
        dist = phase_dist(dev, smi, procs)
    finally:
        stop_dryrun(procs)

    main_t, scale_t = kern["timings"]
    t = flash["timings"]

    def moe_rows(*keys):
        """The flash timing rows at one model's calls."""
        return {k: {f: t[k].get(f) for f in (
            "case", "ms", "device_us", "plain_ms", "library_ms", "bound_ms",
            "bound_by", "cold_ms", "library_cold_ms") if f in t[k]}
            for k in keys}

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
        "launches": (launches + live["launches"] + live["proxy_launches"]
                     + train["ttl_launches"] + dist["examples_ttl"]),
        "launches_by_path": {"replay": launches,
                             "live_differential": live["launches"],
                             "live_proxy": live["proxy_launches"],
                             "train_store": train["ttl_launches"],
                             "examples": dist["examples_ttl"]},
        "max_abs_err": kern["max_abs_err"],
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
        "gemma_serve_launches": gemma["ttl_launches"],
    },
        flash_entry("flash_attention_wgmma", "wgmma", t["wgmma_prefill"],
                    serve["routes"]["wgmma"] + train["wgmma_eval"]
                    + encode["wgmma"] + moe["routes"]["wgmma"]
                    + gemma["routes"]["wgmma"] + mixers["wgmma"]
                    + dist["wgmma"] + dist["examples_flash"]["wgmma"],
                    launches_by_path={"serve": serve["routes"]["wgmma"],
                                      "train_eval": train["wgmma_eval"],
                                      "encode": encode["wgmma"],
                                      "moe_serve": moe["routes"]["wgmma"],
                                      "gemma_serve": gemma["routes"]["wgmma"],
                                      "mixers": mixers["wgmma"],
                                      "dist_pipeline": dist["wgmma"],
                                      "examples_serve_decode":
                                          dist["examples_flash"]["wgmma"]},
                    qwen2_moe=moe_rows("wgmma_moe_prefill"),
                    gemma3=moe_rows("wgmma_gemma_prefill"),
                    nemotron=moe_rows("wgmma_nemotron_prefill"),
                    deepseek_mla=moe_rows("wgmma_deepseek_prefill"),
                    hubert={k: {f: t[k].get(f) for f in (
                        "case", "ms", "device_us", "plain_ms", "library_ms",
                        "bound_ms", "bound_by")}
                        for k in ("wgmma_hubert", "wgmma_hubert_1000")}),
        flash_entry("flash_attention_splitkv", "splitkv", t["splitkv_decode"],
                    serve["routes"]["splitkv"] + moe["routes"]["splitkv"]
                    + gemma["routes"]["splitkv"] + mixers["splitkv"]
                    + dist["examples_flash"]["splitkv"],
                    launches_by_path={"serve": serve["routes"]["splitkv"],
                                      "moe_serve": moe["routes"]["splitkv"],
                                      "gemma_serve":
                                          gemma["routes"]["splitkv"],
                                      "mixers": mixers["splitkv"],
                                      "examples_serve_decode":
                                          dist["examples_flash"]["splitkv"]},
                    qwen2_moe=moe_rows("splitkv_moe_decode"),
                    gemma3=moe_rows("splitkv_gemma_ring_decode",
                                    "splitkv_gemma_global_decode"),
                    nemotron=moe_rows("splitkv_nemotron_decode"),
                    decode_8k={k: t["splitkv_decode_8k"][k] for k in
                               ("case", "ms", "device_us", "bound_ms",
                                "library_ms")}),
        flash_entry("flash_attention", "simt", t["simt_f32"],
                    serve["simt_gate"] + train["simt_launcher_serve"]
                    + moe["simt_gate"] + gemma["routes"]["simt"]
                    + mixers["simt"] + dist["examples_flash"]["simt"],
                    launches_by_path={
                        "serve_f32_gate": serve["simt_gate"],
                        "launcher_serve_defaults":
                            train["simt_launcher_serve"],
                        "moe_serve_f32_gate": moe["simt_gate"],
                        "gemma_serve": gemma["routes"]["simt"],
                        "mixers_reduced": mixers["simt"],
                        "examples_serve_decode":
                            dist["examples_flash"]["simt"]},
                    launches_note="the f32 gates' forwards, the serve "
                                  "launcher's reduced defaults and the "
                                  "reduced configs' card-vs-CPU runs (head "
                                  "dim 8 padded to 64); it takes no bf16 "
                                  "call",
                    d256=moe_rows("simt_d256")),
        moe_decode_entry(moe_kern, moe["moe_decode"], mixers["moe_decode"]),
        mla_decode_entry(mla_kern, mixers["mla_decode"]),
        rope_cache_entry(rope_kern, {"serve": serve["rope_cache"],
                                     "moe_serve": moe["rope_cache"],
                                     "gemma_serve": gemma["rope_cache"],
                                     "mixers": mixers["rope_cache"]}),
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
