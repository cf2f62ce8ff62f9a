"""The port's replaylint (``repro_torch.analysis``) against the reference's.

- The port's storage core (``src/repro_torch/core``) is clean, and its one
  suppression is the reference's sanctioned wall-clock default.
- Every snippet that ``tests/test_replaylint.py`` lints (read from that
  file's AST) gives the same findings and suppressions, code, place and
  message, through both packages; so do the RS005 plane pairs.
- A charge dropped from a temporary copy of the port's ``ledger.py`` is
  reported by RS005 beside the port's ``simulator.py``.
- The port's RS002 also flags torch's global RNG: draws without
  ``generator=`` and ``torch.manual_seed``.
- The CLI's exit codes: 0 clean, 1 findings, 2 usage error; its default
  path is the port's core.
"""

import ast
import re
import shutil
import textwrap
from pathlib import Path

import pytest

from repro.analysis import run_analysis as r_run_analysis
from repro_torch.analysis import UsageError, run_analysis
from repro_torch.analysis.__main__ import main

REPO = Path(__file__).resolve().parents[1]
CORE = REPO / "src" / "repro_torch" / "core"


def _lint_snippets():
    """``(id, source, select)`` of every ``lint(tmp_path, src, ...)`` call in
    ``tests/test_replaylint.py``; a source named by a variable is that
    function's string assignment."""
    tree = ast.parse((REPO / "tests" / "test_replaylint.py").read_text())
    out = []
    for fn in tree.body:
        if not isinstance(fn, ast.FunctionDef):
            continue
        strings = {t.id: node.value.value for node in ast.walk(fn)
                   if isinstance(node, ast.Assign)
                   and isinstance(node.value, ast.Constant)
                   for t in node.targets if isinstance(t, ast.Name)}
        calls = [n for n in ast.walk(fn) if isinstance(n, ast.Call)
                 and getattr(n.func, "id", None) == "lint"]
        for i, call in enumerate(sorted(calls, key=lambda n: (n.lineno, n.col_offset))):
            arg = call.args[1]
            src = arg.value if isinstance(arg, ast.Constant) else strings[arg.id]
            select = next((ast.literal_eval(k.value) for k in call.keywords
                           if k.arg == "select"), None)
            out.append(pytest.param(src, select, id=f"{fn.name}-{i}"))
    return out


SNIPPETS = _lint_snippets()


def _view(result):
    return ([(f.code, f.line, f.col, f.message) for f in result.findings],
            [(f.code, f.line, f.col, f.message) for f in result.suppressed])


def test_snippets_were_found():
    assert len(SNIPPETS) >= 20


@pytest.mark.parametrize("src,select", SNIPPETS)
def test_reference_snippets_give_the_reference_findings(tmp_path, src, select):
    f = tmp_path / "snippet.py"
    f.write_text(textwrap.dedent(src))
    assert (_view(run_analysis([str(f)], select=select))
            == _view(r_run_analysis([str(f)], select=select)))


def _write_planes(tmp_path, sim_fields, ledger_fields):
    for name, fields in (("simulator", sim_fields), ("ledger", ledger_fields)):
        body = "\n".join(f"        self.report.{f} += 1.0" for f in fields)
        (tmp_path / f"{name}.py").write_text(
            f"class {name.title()}:\n    def charge(self):\n{body}\n")


@pytest.mark.parametrize("sim,ledger", [
    (["network", "ops"], ["ops"]),
    (["network", "ops", "storage"], ["storage", "ops", "network"]),
    (["ops"], ["ops", "storage_base"]),
    (["network"], None),
])
def test_rs005_plane_pairs_match_reference(tmp_path, sim, ledger):
    if ledger is None:            # a single-plane run
        (tmp_path / "simulator.py").write_text(
            "class S:\n    def charge(self):\n        self.report.network += 1.0\n")
    else:
        _write_planes(tmp_path, sim, ledger)
    got = _view(run_analysis([str(tmp_path)]))
    assert got == _view(r_run_analysis([str(tmp_path)]))
    assert [c for c, *_ in got[0]] == (["RS005"] if ledger and set(sim) != set(ledger)
                                       else [])


# -- the port's own core ------------------------------------------------------

def test_port_core_is_replaylint_clean():
    result = run_analysis([str(CORE)])
    assert [f.render() for f in result.findings] == []


def test_port_core_suppresses_only_the_sanctioned_boundary():
    """The one suppression is the reference's: the VirtualStore's wall-clock
    default at the serving boundary, with its reason beside it."""
    result = run_analysis([str(CORE)])
    assert [(Path(f.path).name, f.code) for f in result.suppressed] == [
        ("virtual_store.py", "RS001")]
    line = (CORE / "virtual_store.py").read_text().splitlines()[
        result.suppressed[0].line - 1]
    assert "replaylint: disable=RS001" in line
    above = "\n".join((CORE / "virtual_store.py").read_text().splitlines()[
        result.suppressed[0].line - 7:result.suppressed[0].line - 1])
    assert "sanctioned wall-clock default" in above


def test_port_analysis_package_is_self_clean():
    result = run_analysis([str(REPO / "src" / "repro_torch" / "analysis")])
    assert [f.render() for f in result.findings] == []


def _single_site_charges():
    """Report fields the port's ledger charges on exactly one line."""
    text = (CORE / "ledger.py").read_text()
    fields = re.findall(r"\.report\.(\w+)\s*[+\-]?=", text)
    return sorted(f for f in set(fields) if fields.count(f) == 1)


@pytest.mark.parametrize("field", _single_site_charges())
def test_dropped_ledger_charge_is_reported(tmp_path, field):
    shutil.copy(CORE / "simulator.py", tmp_path / "simulator.py")
    lines = (CORE / "ledger.py").read_text().splitlines(keepends=True)
    hit = [i for i, ln in enumerate(lines)
           if re.search(rf"\.report\.{field}\s*[+\-]?=", ln)]
    assert len(hit) == 1
    i = hit[0]
    indent = lines[i][:len(lines[i]) - len(lines[i].lstrip())]
    lines[i] = f"{indent}pass\n"
    (tmp_path / "ledger.py").write_text("".join(lines))
    result = run_analysis([str(tmp_path)])
    assert [f.code for f in result.findings] == ["RS005"]
    assert field in result.findings[0].message
    assert result.findings[0].path.endswith("simulator.py")
    (tmp_path / "ledger.py").write_text((CORE / "ledger.py").read_text())
    assert run_analysis([str(tmp_path)]).findings == []


def test_single_site_charges_exist():
    assert len(_single_site_charges()) >= 3


# -- RS002 on torch's RNG -----------------------------------------------------

@pytest.mark.parametrize("call,flagged", [
    ("torch.rand(3)", True),
    ("torch.randn(2, 3, dtype=torch.float32)", True),
    ("torch.randint(0, 10, (4,))", True),
    ("torch.randperm(8)", True),
    ("torch.randn_like(x)", True),
    ("torch.manual_seed(0)", True),
    ("torch.rand(3, generator=g)", False),
    ("torch.randn(2, 3, generator=torch.Generator().manual_seed(1))", False),
    ("torch.randint(0, 10, (4,), generator=g)", False),
    ("torch.randperm(8, generator=g)", False),
    ("g.manual_seed(0)", False),
    ("torch.zeros(3)", False),
])
def test_rs002_flags_torch_global_rng(tmp_path, call, flagged):
    f = tmp_path / "snippet.py"
    f.write_text(f"import torch\n\n\ndef draw(x, g):\n    return {call}\n")
    result = run_analysis([str(f)])
    assert [x.code for x in result.findings] == (["RS002"] if flagged else [])
    # The reference's rule knows no torch: it flags none of these.
    assert r_run_analysis([str(f)]).findings == []


def test_rs002_resolves_torch_imports(tmp_path):
    f = tmp_path / "snippet.py"
    f.write_text("import torch as T\nfrom torch import randn, manual_seed\n\n"
                 "def f():\n    manual_seed(1)\n    return T.rand(2), randn(2)\n")
    assert [x.code for x in run_analysis([str(f)]).findings] == ["RS002"] * 3


# -- the CLI ------------------------------------------------------------------

def test_cli_exit_codes(tmp_path, capsys, monkeypatch):
    bad = tmp_path / "bad.py"
    bad.write_text("import torch\nX = torch.randn(3)\n")
    good = tmp_path / "good.py"
    good.write_text("def f(now):\n    return now\n")
    broken = tmp_path / "broken.py"
    broken.write_text("def f(:\n")
    assert main([str(bad)]) == 1
    assert main([str(good)]) == 0
    assert main([str(tmp_path / "missing.py")]) == 2
    assert main([str(broken)]) == 2
    assert main(["--select", "RS999", str(good)]) == 2
    assert main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for code in ("RS001", "RS002", "RS003", "RS004", "RS005", "RS006"):
        assert code in out
    with pytest.raises(UsageError):
        run_analysis([str(good)], select=["RS999"])
    monkeypatch.chdir(REPO)       # the default path: the port's core
    capsys.readouterr()
    assert main([]) == 0
    n_core = len(list(CORE.rglob("*.py")))
    assert f"in {n_core} file(s)" in capsys.readouterr().out
    assert main(["--show-suppressed"]) == 0
    assert "virtual_store.py" in capsys.readouterr().out
