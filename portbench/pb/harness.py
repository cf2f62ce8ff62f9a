"""Run one cell once: resolve it by name, check the chip, run its system,
compare with the reference, print the result.

Everything a cell is made of is found by name from ``BENCHMARK.json``:

* the configuration's file (``configs[].file``), whose ``system`` names
  the module of ``pb`` that runs that kind of system;
* the traffic mix, ``traffic/<traffic>.json``, and the generator its
  ``generator`` names, ``traffic/<generator>.py``;
* the plain reference, ``reference/<config>.py`` (``compare``);
* each per-layer metric's reader, ``metrics/<metric>.py`` (``read``).

So a later change adds a cell, a mix, a configuration or a metric by
adding files and entries, and edits none.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
#: Top-level module names the timed process may not hold once the window
#: has closed (compared whole: ``repro_torch`` is the port, ``repro`` is not).
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_spec(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _load_file(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""

    def __init__(self, spec: dict, name: str, bench: Path = BENCH,
                 root: Path = ROOT):
        work = {w["name"]: w for w in spec["workloads"]}
        if name not in work:
            raise KeyError(f"no workload {name!r}; have {sorted(work)}")
        self.work = work[name]
        self.name = name
        confs = {c["name"]: c for c in spec["configs"]}
        self.conf_entry = confs[self.work["config"]]
        with open(root / self.conf_entry["file"]) as f:
            self.config = json.load(f)
        with open(bench / "traffic" / f"{self.work['traffic']}.json") as f:
            self.mix = json.load(f)
        if not (bench / "traffic" / f"{self.mix['generator']}.py").exists():
            raise FileNotFoundError(f"no generator {self.mix['generator']!r}")
        self.bench = bench
        self.reference_path = bench / "reference" / f"{self.work['config']}.py"
        if not self.reference_path.exists():
            raise FileNotFoundError(self.reference_path)

        def mine(m):
            return "workloads" not in m or name in m["workloads"]
        self.end_to_end = [m for m in spec["end_to_end"] if mine(m)]
        self.per_layer = [m for m in spec["per_layer"] if mine(m)]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in self.per_layer if m["moves"] in reported]
        for m in self.per_layer:
            if not (bench / "metrics" / f"{m['name']}.py").exists():
                raise FileNotFoundError(f"no reader for {m['name']}")

    def system(self):
        return importlib.import_module(f"pb.{self.config['system']}")

    def traffic(self):
        gen = self.mix["generator"]
        return _load_file(self.bench / "traffic" / f"{gen}.py",
                          "pb_traffic_" + gen.replace("-", "_").replace(".", "_"))

    def reference(self):
        return _load_file(self.reference_path,
                          "pb_reference_" + self.work["config"].replace("-", "_").replace(".", "_"))

    def reader(self, metric: str):
        return _load_file(self.bench / "metrics" / f"{metric}.py",
                          "pb_metric_" + metric.replace(".", "_").replace("-", "_"))


def _environment(root: Path) -> None:
    """Caches inside the checkout, at fixed paths; no library loads JAX."""
    build = root / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    src = str(root / "src")
    if src not in sys.path:
        sys.path.insert(0, src)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _device_info(chips: int, rec) -> dict:
    import torch
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": int(rec.memory_peak_bytes)}


def execute(cell: Cell, seed: int, seconds: float, trace: bool,
            device: str = "cuda", t_start: float = None) -> dict:
    """Drive the cell and judge it; returns the result object (without
    printing).  ``device="cpu"`` is for tests at reduced sizes only."""
    t_start = time.perf_counter() if t_start is None else t_start
    timing = {}
    rec = cell.system().run(cell.config, cell.mix, cell.traffic(), seed,
                            seconds, trace, device, timing)
    setup_s = timing["window_start"] - t_start
    # The reference runs once the window has closed and the peak is read.
    checks = [(k, v if isinstance(v, int) else float(v), lim) for k, v, lim
              in cell.reference().compare(rec.outputs, cell.config, seed)]
    rec.outputs = None
    correct = all(v <= lim for _k, v, lim in checks) and rec.failed == 0
    metrics = {}
    if not trace:
        values = dict(rec.e2e, setup_s=setup_s)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        for m in cell.per_layer:
            v = cell.reader(m["name"]).read(rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    result = {"correct": bool(correct), "attempted": rec.attempted,
              "failed": rec.failed, "metrics": metrics}
    if device == "cuda":
        result["device"] = _device_info(int(cell.work["chips"]), rec)
    else:
        result["device"] = {"platform": "cpu", "count": 0,
                            "memory_peak_bytes": 0}
    if trace and rec.trace is not None:
        result["device"]["busy_s"] = rec.trace["busy_s"]
        result["device"]["window_s"] = rec.trace["window_s"]
        result["breakdown"] = {"device_ops": rec.trace["device_ops"],
                               "idle_gaps": rec.trace["idle_gaps"]}
    result["counters"] = rec.counters
    result["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in checks}
    return result


def main(argv, t_start: float) -> int:
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = Cell(load_spec(), args.workload)
    _environment(ROOT)
    import torch
    torch.set_num_threads(1)
    chips = int(cell.work["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: cell {cell.name} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    result = execute(cell, args.seed, args.seconds, bool(args.trace),
                     "cuda", t_start)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 4
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(f"correct: {result['correct']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    sys.stdout.flush()
    return 0
