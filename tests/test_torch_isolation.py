"""The port stands alone: it never imports JAX or the JAX package.

A port that re-exported reference modules would pass its diffs trivially, so
this is checked two ways: by importing every module of ``repro_torch`` in a
fresh interpreter and reading ``sys.modules``, and by an AST scan of every
source file of the port and of ``chip_smoke.py``.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _module_names():
    out = []
    for path in sorted(PORT.rglob("*.py")):
        parts = path.relative_to(ROOT / "src").with_suffix("").parts
        out.append(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
    return out


def test_importing_every_port_module_loads_no_jax_and_no_repro():
    code = (
        "import importlib, json, sys\n"
        f"for m in {_module_names()!r}:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] "
        f"in {FORBIDDEN!r})))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0], node.lineno
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0], node.lineno


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_source_imports_no_jax_and_no_repro(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [(root, line) for root, line in _imported_roots(tree)
           if root in FORBIDDEN]
    assert bad == [], f"{path.relative_to(ROOT)} imports {bad}"


def test_the_port_has_the_modules_of_its_slice():
    want = {"costmodel", "histogram", "ttl_policy", "expiry", "engine", "api",
            "traces", "ledger", "routing", "policies", "oracle", "simulator",
            "workloads"}
    assert want <= {p.stem for p in (PORT / "core").glob("*.py")}
    assert {"ref", "ttl_scan", "ops"} <= {
        p.stem for p in (PORT / "kernels").glob("*.py")}
    assert (PORT / "kernels" / "csrc" / "ttl_scan.cu").is_file()
