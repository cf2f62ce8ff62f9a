"""The serving cells on the CPU at a reduced size: the port agrees with the
reference; the control and each fault the cell can have come out not
correct.  The comparison is the one a run makes (``harness.execute``)."""

import pytest
import torch
from conftest import SMALL_MODEL, tiny_cell

from pb import harness

SERVE_CELLS = [w["name"] for w in harness.load_spec()["workloads"]
               if w["config"] == "qwen2-moe-a2.7b"]


def _run(cell, seed=21, seconds=1.5):
    return harness.execute(cell, seed, seconds, False, "cpu")


@pytest.mark.parametrize("name", SERVE_CELLS)
def test_the_port_agrees_with_the_reference(name):
    res = _run(tiny_cell(name), seed=2**31 + 99)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_control_fp8_is_not_correct(seed):
    """The reference in float8 put in the program's place
    (``control_outputs``: its own first tokens, routes and K / V rows over
    the same prompts and served tokens), judged by the same ``compare``,
    reads above a limit, where the program reads below every one (at 8
    layers of width 512; the program there reads ~10x below the limits)."""
    cell = tiny_cell("qwen2moe-chat-reuse", SMALL_MODEL)
    ref = cell.reference()
    rec = cell.system().run(cell.config, cell.mix, cell.traffic(), seed, 1.0,
                            False, "cpu", {})
    program = ref.compare(rec.outputs, cell.config, seed)
    control = ref.compare(ref.control_outputs(rec.outputs, cell.config),
                          cell.config, seed)
    assert all(v <= lim for _k, v, lim in program), program
    assert not all(v <= lim for _k, v, lim in control), control


#: Fan-in axes of the reduced models' leaves the defaults do not name.
_FAN_IN = {"w_dkv": [0], "w_uk": [0], "w_uv": [0], "w_gate": [0],
           "w_up": [0], "w_down": [0], "in_proj": [0], "out_proj": [0],
           "x_proj": [0], "conv_w": [0], "dt_w": [0]}


@pytest.mark.parametrize("arch, rows", [
    ("deepseek-v2-lite-16b", {("prefix", "layer0", "ckv"), ("prefix", "layer0", "krope"),
                              ("blocks", "pos0", "ckv"), ("blocks", "pos0", "krope")}),
    ("jamba-v0.1-52b", {("blocks", "pos4", "k"), ("blocks", "pos4", "v")}),
])
def test_a_prefix_and_a_pattern_layout_are_served_and_recorded(arch, rows, monkeypatch):
    """A model with an unstacked prefix (deepseek's dense first layer, MLA
    caches) or a pattern of mixers (jamba's Mamba and attention, MoE every
    other layer) runs through the serving system unchanged: the routes of
    every MoE layer and the decoded rows of every cache with a sequence
    axis reach the reference's sample."""
    from repro_torch.configs import get_config

    from pb import serve
    cfg = get_config(arch).reduced()
    monkeypatch.setattr(serve, "port_config", lambda m: cfg)
    cell = tiny_cell("qwen2moe-chat-reuse")
    m = dict(cell.config, fan_in_axes=_FAN_IN)
    rec = serve.run(m, cell.mix, cell.traffic(), 5, 1.0, False, "cpu", {})
    n_moe = (sum(s.mlp == "moe" for s in cfg.prefix)
             + cfg.pattern_repeats() * sum(s.mlp == "moe" for s in cfg.pattern))
    gen = cell.mix["gen_tokens"]
    assert rec.attempted >= 1 and rec.outputs["samples"]
    for sample in rec.outputs["samples"]:
        b, length = sample["prompt"].shape
        assert len(sample["routes"]) == n_moe
        assert all(r.shape == (b, length + gen - 1, cfg.moe.top_k)
                   for r in sample["routes"])
        got = {(g, n, k) for g, layers in sample["kv"].items()
               for n, leaves in layers.items() for k in leaves}
        assert got == rows
        for g, n, k in got:
            x = sample["kv"][g][n][k]
            assert x.shape[1 if g == "prefix" else 2] == gen


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def _wrap_step(monkeypatch, fn):
    from repro_torch.launch import serve as launch_serve
    orig = launch_serve.serve_step
    calls = [0]

    def step(cfg, params, caches, tokens, pos, *a, **k):
        calls[0] += 1
        return fn(orig, calls[0], cfg, params, caches, tokens, pos, *a, **k)
    monkeypatch.setattr(launch_serve, "serve_step", step)


def test_fault_a_step_leaving_the_cache_unchanged_is_not_correct(monkeypatch):
    """Decode steps that return the caches they were given unwritten."""
    def fault(orig, n, cfg, params, caches, tokens, pos, *a, **k):
        copy = _clone(caches)
        logits, _ = orig(cfg, params, copy, tokens, pos, *a, **k)
        return logits, caches
    _wrap_step(monkeypatch, fault)
    assert not _run(tiny_cell("qwen2moe-chat-reuse"))["correct"]


def test_fault_half_the_batch_left_out_is_not_correct(monkeypatch):
    """Decode steps that compute the first half of the batch and hand its
    logits to the other half."""
    def fault(orig, n, cfg, params, caches, tokens, pos, *a, **k):
        logits, caches = orig(cfg, params, caches, tokens, pos, *a, **k)
        half = logits.shape[0] // 2
        logits = torch.cat([logits[:half], logits[:half]])
        return logits, caches
    _wrap_step(monkeypatch, fault)
    assert not _run(tiny_cell("qwen2moe-chat-reuse"))["correct"]


def test_fault_a_token_altered_where_it_is_produced_is_not_correct(monkeypatch):
    """One decode step in ten puts its least likely token first in one
    sequence."""
    def fault(orig, n, cfg, params, caches, tokens, pos, *a, **k):
        logits, caches = orig(cfg, params, caches, tokens, pos, *a, **k)
        if n % 10 == 0:
            logits = logits.clone()
            logits[0, logits[0].argmin()] = logits[0].max() + 1
        return logits, caches
    _wrap_step(monkeypatch, fault)
    assert not _run(tiny_cell("qwen2moe-chat-reuse"))["correct"]
