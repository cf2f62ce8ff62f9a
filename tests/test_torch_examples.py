"""The port's examples (``examples/torch_*.py``) on the CPU, each in a
subprocess at small arguments, against the reference's examples.

The store examples print what the reference's print: the same lines,
dollars and counters (the proxy demo's endpoints, which are free ports,
masked).  The training example's outage drill recovers and pays the
reference's egress; the serving example's requests miss and hit the KV
tier as the reference's do.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"


def _run(script: str, *args: str, timeout: int = 300) -> str:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, str(EXAMPLES / script), *args],
                          env=env, cwd=ROOT, capture_output=True, text=True,
                          timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def _mask_endpoints(text: str) -> str:
    return re.sub(r"http://127\.0\.0\.1:\d+", "http://127.0.0.1:PORT", text)


@pytest.mark.parametrize("name, args", [
    ("quickstart", ()),
    ("multicloud_placement", ("--objects", "20", "--months", "3")),
    ("s3_proxy_demo", ()),
])
def test_store_examples_print_the_references_output(name, args):
    got = _run(f"torch_{name}.py", *args, "--device", "cpu")
    want = _run(f"{name}.py", *args)
    assert _mask_endpoints(got) == _mask_endpoints(want)
    assert "$" in got or "->" in got


def test_train_example_recovers_and_pays_the_references_egress():
    args = ("--steps", "4", "--tiny", "--checkpoint-every", "2",
            "--fail-at", "3")
    got = _run("torch_train_100m.py", *args, "--device", "cpu")
    want = _run("train_100m.py", *args)
    assert "recovered from checkpoint step 2" in got
    egress = [ln.split("total egress")[-1] for ln in (got, want)
              for ln in ln.splitlines() if "total egress" in ln]
    assert len(egress) == 2 and egress[0] == egress[1], egress
    loss = float(re.search(r"loss=([0-9.]+)", got).group(1))
    assert 0 < loss < 10


def test_serve_example_misses_then_hits_as_the_reference():
    args = ("--requests", "4", "--gen", "4")
    got = _run("torch_serve_decode.py", *args, "--device", "cpu")
    want = _run("serve_decode.py", *args)

    def hits(text):
        return re.findall(r"req \d+: hit=(\w+)", text)

    assert hits(got) == hits(want) == ["no", "no", "no", "yes"]
    assert "'misses': 3" in got


def test_examples_default_to_the_card():
    if _cuda_available():
        pytest.skip("a card is present")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, str(EXAMPLES / "torch_quickstart.py")],
                          env=env, cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr


def _cuda_available() -> bool:
    import torch

    return torch.cuda.is_available()
