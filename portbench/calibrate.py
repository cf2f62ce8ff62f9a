"""Readings for the limits of ``correct``: the program's on many seeds, and
the control's.  Not run by the benchmark's own runs.

    python3 portbench/calibrate.py --workload <name> --seconds <s> \\
        --seeds <n> [<n> ...] [--control fp8]

One process runs every seed (set-up is long), on the chip.  Each seed
prints one JSON line: the program's readings (``program``: each compared
number beside its limit, and ``correct``) and, with ``--control fp8``, the
control's (``control``, the same):

``fp8``
    the reference in float8 e4m3 (weights per output column, activations
    per row) put in the program's place over the same prompts and served
    tokens (``reference.control_outputs``), judged by the reference's own
    ``compare`` as a run is.  It has to come out not correct.

The limits in ``reference/<config>.py`` are set from these readings
(PERF.md gives them).
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

from pb import harness  # noqa: E402


def _judged(checks) -> dict:
    out = {k: {"value": v, "limit": lim} for k, v, lim in checks}
    out["correct"] = all(v <= lim for _k, v, lim in checks)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench/calibrate.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", choices=("fp8",))
    args = ap.parse_args(argv)
    cell = harness.Cell(harness.load_spec(), args.workload)
    harness._environment(harness.ROOT)
    import torch
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 3
    ref = cell.reference()
    for seed in args.seeds:
        t0 = time.perf_counter()
        rec = cell.system().run(cell.config, cell.mix, cell.traffic(), seed,
                                args.seconds, False, "cuda", {})
        line = {"workload": args.workload, "seed": seed,
                "attempted": rec.attempted, "e2e": rec.e2e,
                "program": _judged(ref.compare(rec.outputs, cell.config, seed))}
        if args.control == "fp8":
            low = ref.control_outputs(rec.outputs, cell.config)
            line["control"] = _judged(ref.compare(low, cell.config, seed))
            del low
        line["control_name"] = args.control
        line["seconds"] = time.perf_counter() - t0
        rec = None
        print(json.dumps(line), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
