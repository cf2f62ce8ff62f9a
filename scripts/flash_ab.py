#!/usr/bin/env python3
"""Time the flash-attention routes of two source trees on one card, in turns.

    python3 scripts/flash_ab.py --tree build/parent/src --tree src

Each ``--tree`` is a ``src`` directory holding a ``repro_torch`` package (the
checkout's own, or another commit's unpacked by ``git archive`` into a
git-ignored directory).  The trees run in turns A, B, B, A (or once each
with ``--once``), each in a process of its own, so the two packages never
meet in one interpreter.  Each run builds its tree's kernels into that
tree's ``build/`` and measures, on NVIDIA's card, with ``chip_smoke.py``'s
helpers:

- the ``simt`` route at the f32 gate's call (B 1, Hq 32, Hkv 8, S 256,
  D 64, causal, f32);
- hubert-xlarge's attention call (B 4, H 16, S 1024, D 80, not causal,
  bf16) on the route the tree's planner picks, and on ``simt`` where the
  tree's ``simt`` takes bf16;
- the serving prefill on ``wgmma`` (B 4, Hq 32, Hkv 8, S 1024, D 64,
  causal, bf16), and qwen2-moe-a2.7b's (B 4, 16 / 16 heads of 128);
- the serving decode step on ``splitkv`` (B 4, Hq 32, Hkv 8, a 1,056-slot
  cache at position 1,040, D 64, bf16);
- scaled_dot_product_attention at each of those shapes, as a yardstick;
- hubert-xlarge's eval step at full width (48 layers, bf16, seeded random
  weights, B 4 x S 1024 frames from the frontend stub of
  ``repro_torch.launch.train``): the median ms of 5 steps after 2, and each
  route's launches in one step.

Each call's time is by CUDA events (median over repetitions) and by the
profiler's device time.  It prints one JSON line per run and, last, all of
them with the card's ``nvidia-smi`` name and power limit; the same goes to
``chiprun_out/flash_ab.json``.  It needs a card: without one it exits 2.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "chiprun_out" / "flash_ab.json"

F32_GATE = (1, 32, 8, 256, 256, 64, True, 0, "float32")
HUBERT_ATTN = (4, 16, 16, 1024, 1024, 80, False, 0, "bfloat16")
SERVE_PREFILL = (4, 32, 8, 1024, 1024, 64, True, 0, "bfloat16")
SERVE_DECODE = (4, 32, 8, 1, 1056, 64, True, 1040, "bfloat16")
MOE_PREFILL = (4, 16, 16, 1024, 1024, 128, True, 0, "bfloat16")
EVAL_BATCH, EVAL_SEQ, EVAL_WARMUP, EVAL_STEPS = 4, 1024, 2, 5


def _frames(cfg, tokens):
    """The frontend stub of ``launch.train``: tokens hashed into frame
    embeddings through a seeded table.  Written out here because a parent
    tree may lack ``launch.train.frontend_frames``; it must match that
    function (``tests/test_torch_encode.py`` checks it)."""
    import numpy as np

    table = np.random.default_rng(0).normal(
        size=(cfg.vocab, cfg.frontend_dim)).astype(np.float32)
    return np.take(table, tokens, axis=0)


def _attention_row(sm, case, route, n_per):
    import torch
    from repro_torch.kernels import flash_attention as fa

    causal, off = case[6], case[7]
    q, k, v = sm.flash_inputs(case, "cuda")
    qs, ks, vs = sm._bshd(q), sm._bshd(k), sm._bshd(v)
    splits = fa.plan(qs, ks, causal, off)[1]

    def call():
        return fa._launch(route, qs, ks, vs, causal, off, splits)

    try:
        call()
    except (TypeError, ValueError) as exc:      # the route does not take it
        return {"case": list(case), "route": route, "not_taken": str(exc)}
    ms = sm.cuda_ms(call, n_per)
    prof = sm.device_profile(lambda: [call() for _ in range(n_per)])
    bound_ms, bound_by = sm.flash_bound_ms(case)
    row = {"case": list(case), "route": route, "ms": ms,
           "device_us": sm.route_device_us(prof, route),
           "library_ms": sm.cuda_ms(sm.sdpa_call(case, q, k, v), n_per),
           "bound_ms": bound_ms, "bound_by": bound_by,
           "share_of_bound": bound_ms / ms}
    del q, k, v, qs, ks, vs
    torch.cuda.empty_cache()
    return row


def _eval_step():
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import init_params
    from repro_torch.train import make_eval_step

    cfg = get_config("hubert-xlarge")
    params = init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab, (EVAL_BATCH, EVAL_SEQ + 1)).astype(np.int32)
    batch = {"inputs": torch.from_numpy(_frames(cfg, toks[:, :-1])).cuda(),
             "labels": torch.from_numpy(toks[:, 1:]).cuda()}
    step = make_eval_step(cfg)
    fa.reset_launches()
    loss = float(step(params, batch)["loss"])
    routes = dict(fa.flash_attention_bshd.route_launches)
    for _ in range(EVAL_WARMUP - 1):
        step(params, batch)
    per = []
    for _ in range(EVAL_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(params, batch)["loss"].item()
        per.append(time.perf_counter() - t0)
    return {"layers": cfg.n_layers, "batch": EVAL_BATCH, "seq": EVAL_SEQ,
            "loss": loss, "route_launches": routes, "step_ms": 1e3 *
            statistics.median(per), "step_ms_all": [1e3 * x for x in per]}


def child(tree: Path) -> dict:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("flash_ab: no CUDA device")
    sys.path[:0] = [str(tree.resolve()), str(ROOT)]
    import chip_smoke as sm
    from repro_torch.kernels import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for name in ("simt", "wgmma"):
        fa.LIBRARIES[name].start()
    q, k = (torch.empty(s, dtype=torch.bfloat16) for s in
            ((4, 1024, 16, 80), (4, 1024, 16, 80)))
    hubert_route = fa.plan(q, k, False, 0)[0]
    return {"tree": str(tree), "fa_file": fa.__file__,
            "simt_f32_gate": _attention_row(sm, F32_GATE, "simt", 50),
            "hubert_planned": _attention_row(sm, HUBERT_ATTN, hubert_route,
                                             10),
            "hubert_simt_bf16": _attention_row(sm, HUBERT_ATTN, "simt", 3),
            "wgmma_serve_prefill": _attention_row(sm, SERVE_PREFILL, "wgmma",
                                                  20),
            "wgmma_moe_prefill": _attention_row(sm, MOE_PREFILL, "wgmma", 20),
            "splitkv_serve_decode": _attention_row(sm, SERVE_DECODE,
                                                   "splitkv", 200),
            "hubert_eval": _eval_step()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", type=Path, default=[],
                    help="a src directory holding repro_torch (repeatable)")
    ap.add_argument("--once", action="store_true",
                    help="run each tree once, not A, B, B, A")
    ap.add_argument("--child", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(args.child)), flush=True)
        return 0
    try:
        import torch
    except ImportError:
        print("flash_ab: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("flash_ab: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    trees = args.tree or [ROOT / "src"]
    order = trees if args.once else trees + trees[::-1]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    runs = []
    for tree in order:
        out = subprocess.run([sys.executable, __file__, "--child", str(tree)],
                             capture_output=True, text=True, timeout=900)
        if out.returncode != 0:
            print(out.stdout[-2000:], out.stderr[-4000:], file=sys.stderr)
            return 1
        runs.append(json.loads(out.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(json.dumps({"nvidia_smi": smi, "runs": runs}, indent=1))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
