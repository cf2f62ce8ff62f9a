"""The port's host spans (``repro_torch.tracing``) on the CPU.

Off (no profiler, no ``recording()``) a span records nothing and the
serving loop's tokens are those of a traced run, bit for bit.  Under the
profiler the serving path's spans are recorded, nested and counted as the
model's layer layout predicts, and each span's profiler range lies inside
the span's own interval on the shared clock.  A full buffer counts what
it drops.
"""

import dataclasses
import threading
import time
from collections import Counter

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import tracing
from repro_torch.configs import get_config
from repro_torch.launch import serve as launch_serve
from repro_torch.models import init_params
from repro_torch.serve.kv_tier import KVTierManager

CPU = torch.device("cpu")
ATTN_CHILDREN = {"attn.qkv", "attn.cache_write", "attn.kernel", "attn.out"}
MOE_CHILDREN = {"moe.route", "moe.dispatch", "moe.experts", "moe.combine",
                "moe.shared", "moe.aux"}
#: Widening of a span's interval when its profiler range is held to it.
SLACK_NS = 100_000


@pytest.fixture(autouse=True)
def empty_buffer():
    tracing.reset()
    yield
    tracing.reset()


def _model(arch):
    cfg = get_config(arch).reduced()
    if arch == "qwen2-moe-a2.7b":
        cfg = dataclasses.replace(cfg, n_layers=3)
    params = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    return cfg, params


def _prompts(cfg, n=3, batch=2, length=12):
    g = torch.Generator().manual_seed(7)
    distinct = [torch.randint(0, cfg.vocab, (batch, length), generator=g)
                for _ in range(2)]
    return [distinct[i % 2] for i in range(n)]


def _serve(cfg, params, gen=4):
    return launch_serve.serve(cfg, params, _prompts(cfg), gen,
                              KVTierManager(device="cpu"), CPU)


def _layers(cfg):
    specs = list(cfg.prefix) + list(cfg.pattern) * cfg.pattern_repeats()
    return (sum(s.mixer in ("attn", "swa") for s in specs),
            sum(s.mlp == "moe" for s in specs))


def test_off_records_nothing_and_serves_the_traced_tokens():
    cfg, params = _model("qwen2-moe-a2.7b")
    off = _serve(cfg, params)
    assert tracing.spans() == [] and tracing.dropped == 0
    with tracing.recording():
        on = _serve(cfg, params)
    assert tracing.spans()
    assert off["hit"] == on["hit"] == [False, False, True]
    for a, b in zip(off["tokens"], on["tokens"]):
        assert torch.equal(a, b)


def test_off_span_is_the_shared_null_context(monkeypatch):
    """With tracing off a span builds nothing: no span object, no range."""
    def fail(*_a):
        raise AssertionError("a span was built with tracing off")
    monkeypatch.setattr(tracing, "_Span", fail)
    assert tracing.span("layer.moe") is tracing._NULL
    with tracing.span("layer.moe"):
        pass
    assert tracing.spans() == []


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "jamba-v0.1-52b"])
def test_profiler_records_nested_spans_as_the_layout_predicts(arch):
    cfg, params = _model(arch)
    with profile(activities=[ProfilerActivity.CPU]):
        out = _serve(cfg, params)
    buf = tracing.spans()
    names = Counter(s[0] for s in buf)
    n_attn, n_moe = _layers(cfg)
    misses = out["hit"].count(False)
    steps = sum(out["decode_steps"])
    forwards = misses + steps
    assert names["serve.request"] == len(out["hit"])
    assert names["serve.prefill"] == misses
    assert names["serve.decode_step"] == steps
    assert names["serve.clone"] == len(out["hit"])
    assert names["model.embed"] == names["model.head"] == forwards
    assert names["layer.attn"] == n_attn * forwards
    assert names["layer.moe"] == n_moe * forwards
    for name, n in names.items():
        if name in ATTN_CHILDREN - {"attn.cache_write"}:
            assert n == names["layer.attn"], name
        elif name in MOE_CHILDREN:
            assert n == names["layer.moe"], name
    assert names["attn.cache_write"] == names["layer.attn"]
    want_parent = {"serve.request": None, "serve.tier": "serve.request",
                   "serve.prefill": "serve.request",
                   "serve.clone": "serve.request",
                   "serve.decode_step": "serve.request",
                   **{c: "layer.attn" for c in ATTN_CHILDREN},
                   **{c: "layer.moe" for c in MOE_CHILDREN}}
    for name, start, end, parent in buf:
        assert 0 < start <= end
        above = buf[parent][0] if parent >= 0 else None
        if name in want_parent:
            assert above == want_parent[name], (name, above)
        else:               # a model span: inside a prefill or a step
            assert above in ("serve.prefill", "serve.decode_step"), (name, above)
        if parent >= 0:
            assert buf[parent][1] <= start and end <= buf[parent][2]
    in_steps = sum(name == "layer.moe" and buf[p][0] == "serve.decode_step"
                   for name, _a, _b, p in buf)
    assert in_steps == n_moe * steps


def _largest_wall_clock_step(fn):
    """Run ``fn`` while a thread samples the wall clock against the
    monotonic one every millisecond; returns the largest jump between two
    samples (ns)."""
    done, steps = threading.Event(), [0]

    def sample():
        last = time.time_ns() - time.monotonic_ns()
        while not done.wait(1e-3):
            now = time.time_ns() - time.monotonic_ns()
            steps[0] = max(steps[0], abs(now - last))
            last = now

    t = threading.Thread(target=sample)
    t.start()
    try:
        fn()
    finally:
        done.set()
        t.join(timeout=10)
    assert not t.is_alive()
    return steps[0]


def test_profiler_ranges_lie_inside_the_spans():
    """The profiler's range of each span, on the profiler's clock, lies in
    the tracer's interval for it widened by 100 us: one clock.  The
    profiler stamps a steady clock and converts it to wall time by a line
    fitted over the run; where the host's wall clock steps against its
    steady clock (a virtual machine's clock keeping: 0.5 ms every ~100 ms
    on some), the converted times can miss it by up to one step, so the
    interval is also widened by the largest step seen during the run."""
    cfg, params = _model("qwen2-moe-a2.7b")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step = _largest_wall_clock_step(lambda: _serve(cfg, params, gen=3))
    slack = SLACK_NS + step
    buf = tracing.spans()
    by_name = {}
    for name, start, end, _p in buf:
        by_name.setdefault(name, []).append((start, end))
    events = {}
    for e in prof.profiler.kineto_results.events():
        if e.name() in by_name:
            events.setdefault(e.name(), []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    assert set(events) == set(by_name)
    for name, spans in by_name.items():
        got = sorted(events[name])
        assert len(got) == len(spans), name
        for (a, b), (s0, s1) in zip(got, sorted(spans)):
            assert s0 - slack <= a <= b <= s1 + slack, (name, a - s0, s1 - b, step)


def test_a_full_buffer_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(tracing, "CAPACITY", 5)
    with tracing.recording():
        with tracing.span("outer"):
            for _ in range(7):
                with tracing.span("inner"):
                    pass
        with tracing.span("late"):
            pass
    buf = tracing.spans()
    assert [s[0] for s in buf] == ["outer"] + ["inner"] * 4
    assert all(s[3] == 0 for s in buf[1:]) and buf[0][2] >= buf[-1][2]
    assert tracing.dropped == 4 and tracing.dropped_ns >= buf[-1][1]
    tracing.reset()
    assert tracing.spans() == [] and tracing.dropped == tracing.dropped_ns == 0


def test_spans_nest_per_thread():
    """Spans opened on several threads at once each take the parent that is
    open on their own thread."""
    import sys
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(k):
            for _ in range(300):
                with tracing.span(f"t{k}.outer"):
                    with tracing.span(f"t{k}.inner"):
                        pass
        with tracing.recording():
            threads = [threading.Thread(target=work, args=(k,)) for k in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    buf = tracing.spans()
    assert len(buf) == 8 * 600
    for name, _a, _b, parent in buf:
        if name.endswith(".inner"):
            assert buf[parent][0] == name.replace("inner", "outer")
        else:
            assert parent == -1
