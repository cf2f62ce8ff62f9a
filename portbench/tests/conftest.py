"""The benchmark's own tests: on the CPU at reduced sizes, and on the card
(the ``cuda`` marker) at the cells' sizes."""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

#: qwen2-moe-a2.7b cut to two layers of width 64 and 8 experts.
TINY_MODEL = dict(
    port_overrides=dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                        head_dim=16, vocab=512,
                        moe=dict(n_routed=8, top_k=2, n_shared=1,
                                 d_ff_expert=32)),
    num_hidden_layers=2, hidden_size=64, num_attention_heads=4,
    num_key_value_heads=4, head_dim=16, moe_intermediate_size=32,
    shared_expert_intermediate_size=32, num_experts=8,
    num_experts_per_tok=2, vocab_size=512)
TINY_PROMPTS = {"length_range": [40, 160], "gen_tokens": 8}
#: A size at which the float8 control reads above the limits: 8 layers of
#: width 512, the published 60 experts and top-4 (a few seconds a run).
SMALL_MODEL = dict(
    port_overrides=dict(n_layers=8, d_model=512, n_heads=8, n_kv_heads=8,
                        head_dim=64, vocab=8192,
                        moe=dict(n_routed=60, top_k=4, n_shared=1,
                                 d_ff_expert=256)),
    num_hidden_layers=8, hidden_size=512, num_attention_heads=8,
    num_key_value_heads=8, head_dim=64, moe_intermediate_size=256,
    shared_expert_intermediate_size=256, num_experts=60,
    num_experts_per_tok=4, vocab_size=8192)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA Hopper card (sm_90a); such a test skips itself "
        "when none is present")


def tiny_cell(name: str, model: dict = TINY_MODEL):
    """The cell ``name`` of BENCHMARK.json at a reduced size."""
    from pb import harness
    cell = harness.Cell(harness.load_spec(), name)
    cell.config.update(model)
    cell.mix.update(TINY_PROMPTS)
    return cell


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread, as the benchmark runs, so that the test
    workers do not oversubscribe the cores; restored after the test."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    """Skips the test without a Hopper card (decided here, at run time)."""
    import torch
    if not torch.cuda.is_available() or torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("needs an NVIDIA Hopper card; none is present")
    return torch.device("cuda")
