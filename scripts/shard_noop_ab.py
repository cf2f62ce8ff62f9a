#!/usr/bin/env python3
"""Time the serving decode step of two source trees on one card, in turns.

    python3 scripts/shard_noop_ab.py --tree build/parent/src --tree src

Each ``--tree`` is a ``src`` directory holding a ``repro_torch`` package (the
checkout's own, or another commit's unpacked by ``git archive`` into a
git-ignored directory).  The trees run in turns A, B, B, A (or once each
with ``--once``), each in a process of its own.  Each run builds its tree's
kernels into that tree's ``build/`` and serves ``chip_smoke.py``'s serve
phase's requests through ``repro_torch.launch.serve`` (llama3.2-1b at full
width, bf16, seeded weights; 6 requests of B 4 x 1,024-token prompts, 32
generated tokens) twice, and reports the second pass's decode ms a step
(the host clock over the decode loops, the device synchronised, as the
serve phase reports it), the median and quartiles of 200 more decode steps
timed one by one, and the functions with the most host time over 50 more
steps under ``cProfile``.  It measures what the sharding annotations
(``shard`` / ``gather_fsdp``, which return at once outside a rules context)
cost the host-bound decode step.

``--cost`` measures that cost directly instead, in one run of the first
tree: it counts the calls of each sharding helper (every function of
``repro_torch.distributed.sharding`` a model module imports, and
``layers._w``) in one decode step, times each helper against the code it
stands in for (``shard`` against nothing, ``_w`` against ``param.to``,
``write_seq`` against the slice assignment, ``embed_rows`` against the
row gather, ``current_rules`` against nothing; alternating rounds on the
card's tensors, medians), and reports counts x differences as the host time the
helpers add to a step, beside the step's median and quartiles.

It prints one JSON line per run and, last, the card's ``nvidia-smi`` name
and power limit; the same goes to ``chiprun_out/shard_noop_ab.json``.  It
needs a card: without one it exits 2.
"""

from __future__ import annotations

import argparse
import cProfile
import json
import pstats
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "chiprun_out" / "shard_noop_ab.json"
SERVE_ARGS = ["--arch", "llama3.2-1b", "--no-reduced", "--requests", "6",
              "--batch", "4", "--prompt-len", "1024", "--gen", "32",
              "--seed", "0", "--device", "cuda"]
EXTRA_STEPS = 200
PROFILED_STEPS = 50


def count_helper_calls(step) -> dict:
    """{helper name: calls} over one ``step()``: each function of
    ``repro_torch.distributed.sharding`` bound in a ``repro_torch`` module,
    and ``layers._w``, wrapped by a counter for the call."""
    from repro_torch.distributed import sharding
    from repro_torch.models import layers

    counts, patched = {}, []

    def counting(name, fn):
        def run(*args, **kwargs):
            counts[name] = counts.get(name, 0) + 1
            return fn(*args, **kwargs)
        return run

    for mod in [m for n, m in list(sys.modules.items())
                if n.startswith("repro_torch.") and m is not sharding]:
        for name, fn in list(vars(mod).items()):
            if (callable(fn) and not isinstance(fn, type)
                    and getattr(fn, "__module__", None) == sharding.__name__):
                patched.append((mod, name, fn))
    patched.append((layers, "_w", layers._w))
    for mod, name, fn in patched:
        setattr(mod, name, counting(name, fn))
    try:
        step()
    finally:
        for mod, name, fn in patched:
            setattr(mod, name, fn)
    return counts


def _per_call_s(fn, n: int, rounds: int = 9) -> float:
    """Median over interleaved rounds of ``fn(n)``'s seconds, over ``n``."""
    import torch

    times = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(n)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) / n)
    return statistics.median(times)


def helper_costs(params, caches) -> dict:
    """{helper: (new s, old s)} a call: each helper against the code it
    stands in for, on the decode step's own tensors, the two timed in
    alternating rounds."""
    import torch
    from repro_torch.distributed.sharding import (current_rules, embed_rows,
                                                  shard, write_seq)
    from repro_torch.models.layers import _w

    wq = params["blocks"]["pos0"]["mixer"]["wq"][0]     # layer 0 of the
    k = caches["blocks"]["pos0"]["k"][0]                # stacked blocks
    new = k[:, :1].clone()
    x = torch.zeros((k.shape[0], 1, wq.shape[1], wq.shape[2]),
                    dtype=wq.dtype, device=wq.device)
    emb = params["embed"]["w"]
    tok = torch.zeros((k.shape[0], 1), dtype=torch.long, device=wq.device)
    axes = ("batch", "seq", "heads", None)

    def loop(body):
        def run(n):
            for _ in range(n):
                body()
        return run

    def assign():
        k[:, 7:8] = new

    pairs = {
        "shard": (loop(lambda: shard(x, axes)), loop(lambda: x), 20000),
        "_w": (loop(lambda: _w(wq, wq.dtype)), loop(lambda: wq.to(wq.dtype)),
               20000),
        "write_seq": (loop(lambda: write_seq(k, 7, new)), loop(assign), 2000),
        "embed_rows": (loop(lambda: embed_rows(emb, tok)),
                       loop(lambda: emb[tok]), 2000),
        "current_rules": (loop(current_rules), loop(lambda: None), 20000),
    }
    out = {}
    for name, (helper, plain, n) in pairs.items():
        helper(n // 10)
        plain(n // 10)                        # warm up
        a, b = [], []
        for _ in range(5):
            a.append(_per_call_s(helper, n, rounds=1))
            b.append(_per_call_s(plain, n, rounds=1))
        out[name] = (statistics.median(a), statistics.median(b))
    return out


def noop_cost(cfg, params, caches, tok, pos) -> dict:
    import torch
    from repro_torch.serve import serve_step

    with torch.no_grad():
        counts = count_helper_calls(
            lambda: serve_step(cfg, params, caches, tok, pos))
        costs = helper_costs(params, caches)
    timed = {n: c for n, c in counts.items() if n in costs}
    added = sum(c * (costs[n][0] - costs[n][1]) for n, c in timed.items())
    return {"calls_per_step": counts,
            # [helper, what it stands in for], ns a call
            "ns_per_call": {n: [1e9 * t for t in c] for n, c in costs.items()},
            "timed_within": {"gather_fsdp": "_w"},    # each _w calls it once
            "untimed_calls": sum(c for n, c in counts.items()
                                 if n not in costs and n != "gather_fsdp"),
            "added_us_per_step": 1e6 * added}


def child(tree: Path, cost: bool = False) -> dict:
    sys.path.insert(0, str(tree))
    import torch
    from repro_torch.launch import serve as launch_serve
    from repro_torch.serve import prefill, serve_step

    args = launch_serve.build_parser().parse_args(SERVE_ARGS)
    launch_serve.run(args)                       # build, warm up
    res = launch_serve.run(args)
    serve_ms = 1e3 * sum(res["decode_s"]) / sum(res["decode_steps"])
    cfg, params = res["cfg"], res["params"]
    prompt = launch_serve.make_prompts(cfg, args)[0].to("cuda")
    max_len = args.prompt_len + EXTRA_STEPS + PROFILED_STEPS + 2
    with torch.no_grad():
        logits, caches, pos = prefill(cfg, params, prompt, max_len)
        tok = torch.argmax(logits, -1)[:, None]
        per = []
        for _ in range(EXTRA_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, caches = serve_step(cfg, params, caches, tok, pos)
            tok = torch.argmax(logits, -1)[:, None]
            torch.cuda.synchronize()
            per.append(time.perf_counter() - t0)
            pos += 1
        prof = cProfile.Profile()
        prof.enable()
        for _ in range(PROFILED_STEPS):
            logits, caches = serve_step(cfg, params, caches, tok, pos)
            tok = torch.argmax(logits, -1)[:, None]
            pos += 1
        torch.cuda.synchronize()
        prof.disable()
        extra = noop_cost(cfg, params, caches, tok, pos) if cost else {}
    stats = pstats.Stats(prof).stats
    top = sorted(stats.items(), key=lambda kv: -kv[1][2])[:10]
    return {**extra, "tree": str(tree), "serve_decode_ms_per_step": serve_ms,
            "decode_ms_median": 1e3 * statistics.median(per),
            "decode_ms_quartiles": [1e3 * q for q in
                                    statistics.quantiles(per, n=4)],
            "decode_steps_timed": EXTRA_STEPS,
            "profiled_steps": PROFILED_STEPS,
            "host_top_own_s": [
                {"fn": f"{Path(f).name}:{line}({name})", "calls": st[1],
                 "own_s": st[2]} for (f, line, name), st in top]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", type=Path, default=[],
                    help="a src directory holding repro_torch (repeatable)")
    ap.add_argument("--once", action="store_true",
                    help="run each tree once, not A, B, B, A")
    ap.add_argument("--cost", action="store_true",
                    help="count and time the sharding helpers in one run "
                         "of the first tree, not A, B, B, A")
    ap.add_argument("--child", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(args.child, args.cost)), flush=True)
        return 0
    try:
        import torch
    except ImportError:
        print("shard_noop_ab: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("shard_noop_ab: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    trees = args.tree or [ROOT / "src"]
    order = (trees[:1] if args.cost else trees if args.once
             else trees + trees[::-1])
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    runs = []
    for tree in order:
        out = subprocess.run([sys.executable, __file__, "--child", str(tree)]
                             + ["--cost"] * args.cost,
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
