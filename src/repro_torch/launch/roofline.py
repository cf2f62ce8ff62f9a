"""Roofline analysis: three terms per (arch x shape x mesh).

The port of ``repro.launch.roofline``, on the H100 constants of
:mod:`repro_torch.launch.mesh`.  From each dry-run cell's per-device
numbers (:mod:`repro_torch.launch.step_analysis`):

    compute term    = FLOPs      / peak FLOP/s       (989e12 bf16, H100 SXM)
    memory term     = bytes      / HBM rate          (3.35e12 B/s)
    collective term = coll_bytes / link rate         (50e9 B/s, NDR per card)

plus MODEL_FLOPS = 6*N*D (train; 2*N*D for inference steps, N = active
params for MoE) and the usefulness ratio MODEL_FLOPS / traced FLOPs -- the
number that exposes recompute, replicated attention math and capacity-
factor MoE waste.  The dominant term is the one to work on.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes --out dryrun.json
    PYTHONPATH=src python -m repro_torch.launch.roofline --dryrun dryrun.json --out roofline.md
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, List

from ..configs import get_config, get_shape
from .mesh import HBM_BW, LINK_BW, PEAK_FLOPS_BF16


def model_flops_per_device(arch: str, shape_name: str, n_devices: int) -> float:
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    n_active = cfg.param_count(active_only=True)
    if shape.input_kind == "train":
        tokens = shape.global_batch * shape.seq_len
        total = 6.0 * n_active * tokens
    elif shape.input_kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        total = 2.0 * n_active * tokens
    else:  # decode: one token per sequence
        total = 2.0 * n_active * shape.global_batch
    return total / n_devices


def hint(dom: str, arch: str, shape: str, ratio: float) -> str:
    if dom == "collective":
        return ("collective-bound: next lever is overlapping FSDP gathers "
                "with layer compute / int8-compressing the cross-pod grads")
    if dom == "memory":
        return ("HBM-bound: keep score/state tiles in shared memory (the "
                "CUDA flash kernel, a chunked-scan kernel) or fold "
                "projections into the producing loop (Mamba C-fusion)")
    if ratio < 0.5:
        return ("compute-bound but wasteful (MODEL/traced < 0.5): reduce "
                "recompute and replicated attention math before anything else")
    return ("compute-bound and clean: approach peak by sending attention "
            "through the CUDA flash kernel and fusing fp32 element-wise tails")


def roofline_rows(results: List[dict]) -> List[Dict]:
    rows = []
    for r in results:
        if not r.get("ok"):
            rows.append({
                "arch": r["arch"], "shape": r["shape"], "mesh": r["mesh"],
                "skip": r.get("error", ""),
            })
            continue
        n_dev = 512 if r["mesh"] == "2x16x16" else 256
        flops = r["hlo"]["flops"]
        bytes_ = r["hlo"]["bytes"]
        coll = r["hlo"]["collective_bytes"]
        t_c = flops / PEAK_FLOPS_BF16
        t_m = bytes_ / HBM_BW
        t_n = coll / LINK_BW
        dom = max(("compute", t_c), ("memory", t_m), ("collective", t_n),
                  key=lambda kv: kv[1])[0]
        mf = model_flops_per_device(r["arch"], r["shape"], n_dev)
        ratio = mf / flops if flops else 0.0
        # roofline fraction: useful model flops per second achievable given
        # the dominant term's time (what fraction of peak the card would run)
        step_time = max(t_c, t_m, t_n)
        frac = (mf / step_time) / PEAK_FLOPS_BF16 if step_time > 0 else 0.0
        rows.append({
            "arch": r["arch"], "shape": r["shape"], "mesh": r["mesh"],
            "compute_s": t_c, "memory_s": t_m, "collective_s": t_n,
            "dominant": dom, "model_flops": mf, "hlo_flops": flops,
            "useful_ratio": ratio, "roofline_fraction": frac,
            "hbm_gib": r["memory"].get("total_hbm_bytes", 0) / 2**30,
            "microbatches": r.get("microbatches", 1),
            "hint": hint(dom, r["arch"], r["shape"], ratio),
        })
    return rows


def to_markdown(rows: List[Dict]) -> str:
    out = [
        "| arch | shape | mesh | compute s | memory s | collective s | "
        "dominant | 6ND/traced | roofline frac | HBM GiB | note |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        if "skip" in r:
            out.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} | - | - | - | "
                f"skipped | - | - | - | {r['skip'][:60]} |")
            continue
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {r['compute_s']:.4f} | {r['memory_s']:.4f} "
            f"| {r['collective_s']:.4f} | {r['dominant']} "
            f"| {r['useful_ratio']:.2f} | {r['roofline_fraction']:.3f} "
            f"| {r['hbm_gib']:.1f} | {r['hint'][:60]} |")
    return "\n".join(out)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dryrun", required=True)
    ap.add_argument("--out", default=None)
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)
    with open(args.dryrun) as f:
        results = json.load(f)
    rows = roofline_rows(results)
    md = to_markdown(rows)
    print(md)
    if args.out:
        with open(args.out, "w") as f:
            f.write(md + "\n")
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
