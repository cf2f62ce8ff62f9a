"""deepseek-v2-lite-16b's cell on the CPU at reduced widths: the port
(prefill, then decode through its latent caches, YaRN rope) agrees with
the plain reference's full forward on logits, routes and latent rows; the
float8 control and each fault the cell can have come out not correct; the
mix serves the same work on every seed; a program whose config lacks the
configuration's rope scaling cannot run it; a traced run reads the MLA
layers' host time.  The comparison is the one a run makes
(``harness.execute``)."""

import copy

import numpy as np
import pytest
from conftest import tiny_cell

from pb import harness, serve_mla

CELL = "dsv2lite-longdoc-hits"


def _model(layers, d, heads, vocab, experts, top_k, f, d_ff, latent, nope,
           rope, v):
    return dict(
        port_overrides=dict(n_layers=layers, d_model=d, n_heads=heads,
                            n_kv_heads=heads, head_dim=nope + rope,
                            vocab=vocab, d_ff=d_ff,
                            moe=dict(n_routed=experts, top_k=top_k,
                                     n_shared=2, d_ff_expert=f),
                            mla=dict(kv_lora_rank=latent, qk_nope_dim=nope,
                                     qk_rope_dim=rope, v_head_dim=v)),
        num_hidden_layers=layers, hidden_size=d, num_attention_heads=heads,
        num_key_value_heads=heads, vocab_size=vocab, n_routed_experts=experts,
        num_experts_per_tok=top_k, moe_intermediate_size=f,
        intermediate_size=d_ff, kv_lora_rank=latent, qk_nope_head_dim=nope,
        qk_rope_head_dim=rope, v_head_dim=v)


#: Three layers (the dense first one, two MoE) of width 64.
TINY = _model(3, 64, 4, 512, 8, 2, 32, 128, 32, 16, 8, 16)
#: A size at which the float8 control reads above the limits: 6 layers of
#: width 512, the published 64 experts and top-6 (seconds a run).
SMALL = _model(6, 512, 8, 8192, 64, 6, 128, 1024, 128, 32, 16, 32)
PROMPTS = {"length_range": [48, 48], "gen_tokens": 8}


def _cell(model=TINY):
    cell = tiny_cell(CELL, model)
    cell.mix.update(PROMPTS)
    return cell


def _run(cell, seed=21, seconds=1.5, trace=False):
    return harness.execute(cell, seed, seconds, trace, "cpu")


def test_the_port_agrees_with_the_reference():
    import torch
    assert torch.is_grad_enabled()
    res = _run(_cell(), seed=2**31 + 77)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1
    assert res["counters"]["hits"] == res["counters"]["requests"]
    assert torch.is_grad_enabled()          # the run leaves autograd on


@pytest.mark.parametrize("seed", [3, 4])
def test_control_fp8_is_not_correct(seed):
    """The reference in float8 put in the program's place, judged by the
    same ``compare``, reads above a limit, where the program reads below
    every one."""
    cell = _cell(SMALL)
    ref = cell.reference()
    rec = cell.system().run(cell.config, cell.mix, cell.traffic(), seed, 0.5,
                            False, "cpu", {})
    program = ref.compare(rec.outputs, cell.config, seed)
    control = ref.compare(ref.control_outputs(rec.outputs, cell.config),
                          cell.config, seed)
    assert all(v <= lim for _k, v, lim in program), program
    assert not all(v <= lim for _k, v, lim in control), control


def _wrap_step(monkeypatch, fn):
    from repro_torch.launch import serve as launch_serve
    orig = launch_serve.serve_step
    calls = [0]

    def step(cfg, params, caches, tokens, pos, *a, **k):
        calls[0] += 1
        return fn(orig, calls[0], cfg, params, caches, tokens, pos, *a, **k)
    monkeypatch.setattr(launch_serve, "serve_step", step)


def test_fault_a_step_leaving_its_latent_row_unwritten_is_not_correct(monkeypatch):
    """Decode steps that write their latent rows into a copy of the caches
    and return the caches they were given."""
    def fault(orig, n, cfg, params, caches, tokens, pos, *a, **k):
        logits, _ = orig(cfg, params, copy.deepcopy(caches), tokens, pos, *a, **k)
        return logits, caches
    _wrap_step(monkeypatch, fault)
    res = _run(_cell())
    assert not res["correct"]
    assert res["checks"]["kv_rel_err_max"]["value"] > res["checks"]["kv_rel_err_max"]["limit"]


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
    assert not _run(_cell())["correct"]


@pytest.mark.parametrize("seed", [1, 2**31 + 5, 2**40 + 3])
def test_the_mix_serves_the_same_work_on_every_seed(seed):
    """Every document of the pool is 16,384 tokens, each is prefilled in
    set-up, and every window request is one of them: a hit of the same
    length."""
    cell = harness.Cell(harness.load_spec(), CELL)
    mix = cell.mix
    stream = cell.traffic().stream(mix, 102400, seed)
    assert stream.batch == 4 and stream.gen == 64
    setup = stream.setup_prompts()
    assert [tuple(p.shape) for p in setup] == [(4, 16384)] * 4
    ids = {id(p) for p in setup}
    for i in range(200):
        prompt = stream.request(i)
        assert id(prompt) in ids and prompt.shape == (4, 16384)
    assert np.all(stream.pool_lengths == 16384)


def test_a_program_without_the_rope_scaling_cannot_run_the_configuration():
    cell = _cell()
    m = copy.deepcopy(cell.config)
    m["rope_scaling"]["factor"] = 39
    with pytest.raises(ValueError, match="rope scaling"):
        serve_mla.port_config(m)
    m = copy.deepcopy(cell.config)
    m["kv_lora_rank"] = 64
    with pytest.raises(ValueError, match="kv_lora_rank"):
        serve_mla.port_config(m)
    assert serve_mla.port_config(cell.config).yarn.factor == 40.0


def test_a_traced_run_reads_the_mla_layers():
    """On the CPU the program's spans are recorded (the profiler is on)
    and ``mla_host_ms_per_step`` reads them; no device time, so
    ``mla_decode_roofline`` reads nothing and is left out."""
    res = _run(_cell(), trace=True)
    assert res["correct"], res["checks"]
    assert res["metrics"]["mla_host_ms_per_step"]["value"] > 0
    assert "mla_decode_roofline" not in res["metrics"]
    assert res["counters"]["mla_decode_launches"] == 0


def test_the_roofline_reader_on_a_recorded_trace():
    from pb.mla import mla_decode_bound_s, mla_decode_bytes
    from pb.record import RunRecord
    reader = harness.Cell(harness.load_spec(), CELL).reader("mla_decode_roofline")
    call = dict(b=4, heads=16, kv_len=16447, latent=512, rope=64, item=2)
    assert mla_decode_bytes(**call) == 2 * 4 * (16447 * 576 + 16 * 576 + 16 * 512)
    assert mla_decode_bound_s(**call) == pytest.approx(22.66e-6, rel=1e-3)
    run = RunRecord(trace={"program": {"mla.kernel": {"device_s": 2 * 45.3e-6}},
                           "mla_calls": [call, call]})
    assert reader.read(run) == pytest.approx(100 * 22.66 / 45.3, rel=2e-3)
    assert reader.read(RunRecord(trace={"program": {}, "mla_calls": []})) is None
    assert reader.read(RunRecord()) is None


def test_program_device_charges_the_ops_launched_inside_decode_steps(monkeypatch):
    """A synthetic trace: ops launched inside ``mla.kernel`` spans of a
    decode step count, one launched outside them does not."""
    from repro_torch import tracing

    class Ev:
        def __init__(self, name, dev, start, dur, corr):
            self._n, self._d, self._s, self._u, self._c = name, dev, start, dur, corr

        def name(self):
            return self._n

        def device_type(self):
            return self._d

        def start_ns(self):
            return self._s

        def duration_ns(self):
            return self._u

        def correlation_id(self):
            return self._c

    class Prof:
        class profiler:
            class kineto_results:
                @staticmethod
                def events():
                    return [Ev("cudaLaunchKernel", "CPU", 150, 1, 1),
                            Ev("k1", "DeviceType.CUDA", 400, 30, 1),
                            Ev("cudaLaunchKernel", "CPU", 250, 1, 2),
                            Ev("k2", "DeviceType.CUDA", 500, 20, 2)]

    buf = [("serve.decode_step", 100, 300, -1), ("layer.mla", 110, 200, 0),
           ("mla.kernel", 140, 160, 1)]
    monkeypatch.setattr(tracing, "spans", lambda: buf)
    out = serve_mla.program_device(Prof, 0, 1000)
    assert out == {"mla.kernel": {"device_s": pytest.approx(30e-9), "ops": 1,
                                  "spans": 1}}
