#!/usr/bin/env python3
"""What one rank holds at a dry-run cell's peak, on the CPU's fake tensors.

Traces one cell of ``repro_torch.launch.dryrun`` (optionally cut to fewer
layers, or with another ``remat_policy``) and prints its bytes a rank, its
FLOPs and collective bytes, and the tensors alive at the moment the step's
own tensors peaked, grouped by the op that made them, their shape and
dtype, largest first.

    PYTHONPATH=src python3 scripts/dryrun_peak.py nemotron-4-340b train_4k
    PYTHONPATH=src python3 scripts/dryrun_peak.py nemotron-4-340b train_4k \\
        --layers 4 --remat-policy nothing

Nothing is allocated (fake tensors); a cell takes seconds to minutes of one
core.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.configs import get_config, get_shape  # noqa: E402
from repro_torch.launch import dryrun, step_analysis  # noqa: E402
from repro_torch.launch.mesh import (init_fake_world,  # noqa: E402
                                     make_production_mesh)


class PeakSet(step_analysis.StepAnalysis):
    """:class:`~repro_torch.launch.step_analysis.StepAnalysis` that also
    keeps, for each storage it counts, the op, shape and dtype that made
    it, and a copy of the live set whenever the peak rises."""

    last = None                      # the instance of the latest trace

    def __init__(self):
        super().__init__()
        self.made = {}
        self.at_peak = {}
        self._op = ""
        PeakSet.last = self

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self._op = func._schema.name.split("::")[-1]
        return super().__torch_dispatch__(func, types, args, kwargs)

    def _track(self, out, args=()) -> None:
        peak = self.peak
        for t in step_analysis._tensors(out):
            key = t.untyped_storage()._cdata
            if key not in self._seen:        # a storage (or its address) new
                self.made[key] = (t.untyped_storage().nbytes(), self._op,
                                  tuple(t.shape),
                                  str(t.dtype).replace("torch.", ""))
        super()._track(out, args)
        if self.peak > peak:
            self.at_peak = {k: self.made[k] for k in self._seen
                            if k in self.made}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("arch")
    ap.add_argument("shape")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (0: the config's)")
    ap.add_argument("--remat-policy", choices=("nothing", "dots"),
                    default=None)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    if args.remat_policy:
        cfg = dataclasses.replace(cfg, remat_policy=args.remat_policy)
    shape = get_shape(args.shape)
    step_analysis.StepAnalysis = PeakSet       # trace_cell's analysis
    init_fake_world(256)
    dev = torch.device("cpu")
    mesh = make_production_mesh(multi_pod=False, device=dev)
    t0 = time.perf_counter()
    memory, hlo, mb = dryrun.trace_cell(
        cfg, shape, mesh, dryrun.rules_for(cfg, shape, False), dev)
    seconds = time.perf_counter() - t0
    groups = collections.defaultdict(lambda: [0, 0])
    for nbytes, op, shp, dtype in PeakSet.last.at_peak.values():
        row = groups[(op, shp, dtype)]
        row[0] += nbytes
        row[1] += 1
    print(json.dumps({
        "cell": [cfg.name, shape.name], "layers": cfg.n_layers,
        "remat_policy": cfg.remat_policy, "microbatches": mb,
        "seconds": seconds, "memory": memory, "flops": hlo["flops"],
        "collective_bytes": hlo["collective_bytes"]}))
    for (op, shp, dtype), (nbytes, n) in sorted(
            groups.items(), key=lambda kv: -kv[1][0])[:args.top]:
        print(f"{nbytes / 1e9:9.3f} GB  {n:4d} x {op} {list(shp)} {dtype}")


if __name__ == "__main__":
    main()
