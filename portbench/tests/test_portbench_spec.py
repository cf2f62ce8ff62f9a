"""BENCHMARK.json resolves by name, keeps to the contract's shapes, and a
cell is added by new files and entries alone; nothing under portbench/
imports JAX or the JAX package, and the references import nothing of the
port."""

import ast
import hashlib
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
from conftest import BENCH, ROOT, TINY_MODEL, tiny_cell

from pb import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _spec():
    return harness.load_spec()


def test_benchmark_json_has_the_contract_keys():
    spec = _spec()
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["paths"] == ["portbench"]
    assert 1 <= spec["run_seconds"] <= 51
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("portbench/")
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
    names = [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    assert len(names) == len(set(names))
    assert "setup_s" in names
    for m in spec["end_to_end"]:
        assert 0 < m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    reported = {w["name"]: {m["name"] for m in spec["end_to_end"]
                            if "workloads" not in m or w["name"] in m["workloads"]}
                for w in spec["workloads"]}
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in spec["per_layer"]:
        for w in m["workloads"]:
            assert m["moves"] in reported[w]


@pytest.mark.parametrize("name", [w["name"] for w in harness.load_spec()["workloads"]])
def test_every_cell_resolves_to_its_files(name):
    cell = harness.Cell(_spec(), name)
    assert cell.system().run
    assert cell.reference().compare
    assert cell.end_to_end and cell.per_layer
    for m in cell.per_layer:
        assert cell.reader(m["name"]).read
    assert cell.config["name"] == cell.work["config"]


_ONE_DOC = """
import torch


class _Stream:
    def __init__(self, mix, vocab, seed):
        g = torch.Generator().manual_seed(seed % 2**63)
        self.batch, self.gen = mix["batch"], mix["gen_tokens"]
        self.doc = torch.randint(0, vocab, (self.batch, mix["length"]), generator=g)

    def setup_prompts(self):
        return [self.doc]

    def request(self, i):
        return self.doc


def stream(mix, vocab, seed):
    return _Stream(mix, vocab, seed)
"""


def test_a_cell_is_added_by_new_files_alone(tmp_path):
    """A copy of the benchmark gains a traffic generator, a mix of it, a
    metric reader and a cell; the harness finds them by name and no file
    it had changes."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = _spec()
    before = {p: hashlib.sha256(p.read_bytes()).hexdigest()
              for p in (root / "portbench").rglob("*") if p.is_file()}
    (root / "portbench" / "traffic" / "one-doc.py").write_text(_ONE_DOC)
    (root / "portbench" / "traffic" / "repeat-one.json").write_text(json.dumps(
        {"generator": "one-doc", "batch": 2, "gen_tokens": 4, "length": 48,
         "tier": "shared"}))
    (root / "portbench" / "metrics" / "served_requests.py").write_text(
        "def read(run):\n    return run.counters.get('requests')\n")
    spec["workloads"].append({"name": "qwen2moe-repeat-one",
                              "config": "qwen2-moe-a2.7b",
                              "traffic": "repeat-one", "chips": 1, "why": "test"})
    spec["per_layer"].append({"name": "served_requests", "unit": "requests",
                              "better": "higher", "source": "program_counter",
                              "layer": "launch.serve", "moves": "serve_tokens_per_s",
                              "workloads": ["qwen2moe-repeat-one"]})
    for m in spec["end_to_end"]:
        if "workloads" in m and "qwen2moe-chat-reuse" in m["workloads"]:
            m["workloads"].append("qwen2moe-repeat-one")
    cell = harness.Cell(spec, "qwen2moe-repeat-one", bench=root / "portbench",
                        root=ROOT)
    assert cell.mix["length"] == 48
    assert [m["name"] for m in cell.per_layer] == ["served_requests"]
    cell.config.update(TINY_MODEL)
    res = harness.execute(cell, 7, 1.0, True, "cpu")
    assert res["correct"], res["checks"]
    assert res["metrics"]["served_requests"]["value"] >= 1
    assert res["counters"]["hits"] == res["counters"]["requests"]
    after = {p: hashlib.sha256(p.read_bytes()).hexdigest() for p in before}
    assert before == after


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(str(p.relative_to(BENCH)) for p in BENCH.rglob("*.py")
                                        if "__pycache__" not in p.parts))
def test_no_module_imports_jax_or_the_jax_package(path):
    names = set(_imports(BENCH / path))
    assert not names & set(harness.FORBIDDEN), (path, names)
    if path.startswith("reference"):
        assert "repro_torch" not in names, (path, names)


def test_a_run_loads_no_jax_module():
    """A whole (reduced, CPU) run in a fresh process leaves no module of
    JAX or the JAX package in ``sys.modules``."""
    code = (
        "import sys; sys.path[:0] = ['portbench', 'portbench/tests', 'src']\n"
        "from conftest import tiny_cell\n"
        "from pb import harness\n"
        "for name in ('qwen2moe-chat-reuse', 'qwen2moe-docs-cold'):\n"
        "    assert harness.execute(tiny_cell(name), 5, 1.0, False, 'cpu')['correct']\n"
        "print(harness.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_refuses_without_a_card(tmp_path):
    """Without CUDA the command prints no result and exits non-zero."""
    pytest.importorskip("torch")
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "qwen2moe-docs-cold", "--seed", "3", "--seconds", "1",
                          "--trace", "0"], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0 and not out.stdout.strip()


def test_run_refuses_without_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and portbench/ the
    command prints no result and exits non-zero."""
    shutil.copytree(BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "qwen2moe-docs-cold", "--seed", "3", "--seconds", "1",
                          "--trace", "0"], cwd=tmp_path, capture_output=True,
                         text=True, timeout=120,
                         env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert out.returncode != 0 and not out.stdout.strip()
