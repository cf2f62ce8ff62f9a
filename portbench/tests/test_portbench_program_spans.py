"""The readers of the program's own spans (``repro_torch.tracing``):
``decode_host_ms_per_step``, ``moe_host_ms_per_step`` and
``attn_host_ms_per_step``, on the CPU at a reduced size."""

import pytest
from conftest import tiny_cell

from pb import harness
from pb.record import RunRecord
from repro_torch import tracing

NEW = ("decode_host_ms_per_step", "moe_host_ms_per_step",
       "attn_host_ms_per_step")
SERVE_CELLS = [w["name"] for w in harness.load_spec()["workloads"]
               if w["config"] == "qwen2-moe-a2.7b"]


def _read(name, run):
    return harness.Cell(harness.load_spec(), SERVE_CELLS[0]).reader(name).read(run)


@pytest.mark.parametrize("name", SERVE_CELLS)
def test_a_traced_run_reports_the_program_span_metrics(name, monkeypatch):
    """A traced run stays correct and adds the three metrics, with positive
    values, to every per-layer metric it reports without the program's
    spans."""
    cell = tiny_cell(name)
    with monkeypatch.context() as m:
        m.setattr(tracing, "_profiling", lambda: False)
        before = harness.execute(cell, 2**31 + 17, 1.5, True, "cpu")
    assert before["correct"], before["checks"]
    assert not set(NEW) & set(before["metrics"])
    res = harness.execute(tiny_cell(name), 2**31 + 17, 1.5, True, "cpu")
    assert res["correct"], res["checks"]
    got = {k: v["value"] for k, v in res["metrics"].items()}
    assert set(before["metrics"]) | set(NEW) <= set(got)
    assert all(got[k] > 0 for k in NEW)
    assert got["moe_host_ms_per_step"] + got["attn_host_ms_per_step"] \
        < got["decode_host_ms_per_step"]
    assert all(res["metrics"][k]["unit"] == "ms" for k in NEW)


def test_an_untraced_run_reports_none_of_them():
    res = harness.execute(tiny_cell("qwen2moe-chat-reuse"), 5, 1.0, False, "cpu")
    assert res["correct"], res["checks"]
    assert not set(NEW) & set(res["metrics"])


def _record(spans):
    return RunRecord(spans=list(spans))


@pytest.mark.parametrize("metric", NEW)
def test_the_readers_find_nothing_without_a_decode_step(metric):
    """No benchmark spans, no program spans, program spans of an earlier
    window only, or only spans that are no decode step: ``None``."""
    tracing.reset()
    assert _read(metric, _record([])) is None
    assert _read(metric, _record([(1, 2, "serve.step")])) is None
    with tracing.recording():
        with tracing.span("serve.decode_step"):
            with tracing.span("layer.moe"):
                with tracing.span("layer.attn"):
                    pass
    earlier = tracing.spans()[0]
    later = (earlier[2] + 1, earlier[2] + 10**6, "serve.step")
    assert _read(metric, _record([later])) is None
    window = (earlier[1], earlier[2], "serve.step")
    assert _read(metric, _record([window])) > 0
    tracing.reset()
    with tracing.recording():
        with tracing.span("serve.prefill"):
            with tracing.span("layer.moe"):
                pass
    only = tracing.spans()[0]
    assert _read(metric, _record([(only[1], only[2], "serve.prefill")])) is None
    tracing.reset()


@pytest.mark.parametrize("metric", NEW)
def test_the_readers_find_nothing_when_the_window_dropped_a_span(metric, monkeypatch):
    tracing.reset()
    monkeypatch.setattr(tracing, "CAPACITY", 3)
    with tracing.recording():
        for _ in range(2):
            with tracing.span("serve.decode_step"):
                with tracing.span("layer.moe"):
                    with tracing.span("layer.attn"):
                        pass
    buf = tracing.spans()
    assert tracing.dropped == 3
    window = (buf[0][1], tracing.dropped_ns + 1, "serve.step")
    assert _read(metric, _record([window])) is None
    tracing.reset()
