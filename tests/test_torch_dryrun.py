"""The port's dry-run, step analysis and roofline against the reference.

On a fake (4, 2) ("data", "model") process group the reduced llama3.2-1b
train step (2 microbatches), decode step and prefill trace under
``FakeTensorMode``, as ``tests/test_dryrun_smoke.py`` asks of the
reference: FLOPs and collective bytes (the FSDP gathers) above zero, and
each rank's argument bytes equal to what the reference's ``rules.spec`` and
``_fit_spec`` imply for the same leaves.  The one-device FLOPs of a reduced
prefill forward are held to the reference's ``hlo_analysis.analyze`` of its
jitted forward (the products, 2 x M x N x K, within 5 %);
``model_flops_per_device`` and ``roofline_rows`` equal the reference's.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_NAMES, SHAPE_NAMES, ShapeConfig, get_config
from repro_torch.launch import dryrun, roofline, step_analysis

MESH = {"data": 4, "model": 2}
SHAPES = {"train": ("t16", 16, 8), "decode": ("d32", 32, 8),
          "prefill": ("p16", 16, 8)}


def _shape(kind):
    name, seq, batch = SHAPES[kind]
    return ShapeConfig(name, seq, batch, kind)


@pytest.fixture(scope="module")
def cells():
    """{kind: (memory, hlo, microbatches)} of the reduced cells."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.mesh import init_fake_world

    cfg = get_config("llama3.2-1b").reduced()
    init_fake_world(8)
    mesh = init_device_mesh("cpu", tuple(MESH.values()),
                            mesh_dim_names=tuple(MESH))
    return {kind: dryrun.trace_cell(
        cfg, _shape(kind), mesh, dryrun.rules_for(cfg, _shape(kind), False),
        torch.device("cpu"), mb_override=2 if kind == "train" else None)
        for kind in SHAPES}


@pytest.mark.parametrize("kind", list(SHAPES))
def test_reduced_cells_trace_with_fsdp_gathers(cells, kind):
    memory, hlo, mb = cells[kind]
    assert hlo["flops"] > 0
    assert hlo["collective_bytes"] > 0
    assert hlo["collective_counts"].get("all-gather", 0) > 0
    assert memory["total_hbm_bytes"] >= memory["argument_size_in_bytes"] > 0
    assert mb == (2 if kind == "train" else 1)


def _implied_bytes(rules, schema_leaves, dtypes):
    """Bytes one rank holds of ``schema_leaves`` (path -> (shape, axes)) by
    the reference's spec and fit."""
    from repro.distributed.sharding import _fit_spec

    class _Mesh:
        shape = MESH

    total = 0
    for path, (shape, axes) in schema_leaves.items():
        spec = _fit_spec(_Mesh, rules.spec(axes), shape)
        n = math.prod(shape)
        for entry in spec:
            for a in ((entry,) if isinstance(entry, str) else (entry or ())):
                n //= MESH[a]
        total += n * dtypes(path).itemsize
    return total


def _leaves(schema):
    from repro.models.layers import Spec
    import jax

    flat, _ = jax.tree_util.tree_flatten_with_path(
        schema, is_leaf=lambda x: isinstance(x, Spec))
    return {tuple(k.key for k in path): (sp.shape, sp.axes)
            for path, sp in flat}


@pytest.mark.parametrize("kind", list(SHAPES))
def test_argument_bytes_equal_reference_rules(cells, kind):
    from repro.configs import get_config as ref_get_config
    from repro.configs.base import ShapeConfig as RefShape
    from repro.launch.dryrun import rules_for as ref_rules_for
    from repro.models.transformer import cache_schema, model_schema

    cfg = ref_get_config("llama3.2-1b").reduced()
    name, seq, batch = SHAPES[kind]
    rules = ref_rules_for(cfg, RefShape(name, seq, batch, kind), False)
    params = _leaves(model_schema(cfg))
    f32, i32 = np.dtype(np.float32), np.dtype(np.int32)
    want = 0
    if kind == "train":
        # f32 params, AdamW m and v in f32 (no master: params are f32),
        # the step counter, inputs and labels
        want += 3 * _implied_bytes(rules, params, lambda _p: f32)
        want += 4 + 2 * _implied_bytes(
            rules, {"x": ((batch, seq), ("batch", "seq"))}, lambda _p: i32)
    else:
        want += _implied_bytes(rules, params, lambda _p: f32)
        if kind == "decode":
            want += _implied_bytes(rules, _leaves(cache_schema(cfg, batch, seq)),
                                   lambda _p: f32)
            want += _implied_bytes(
                rules, {"t": ((batch, 1), ("batch", None))}, lambda _p: i32)
        else:
            want += _implied_bytes(
                rules, {"x": ((batch, seq), ("batch", "seq"))}, lambda _p: i32)
    assert cells[kind][0]["argument_size_in_bytes"] == want


def test_one_device_prefill_flops_match_reference_hlo():
    """The products of a reduced prefill forward on one device: the port's
    traced mm/bmm against the reference's dots in its compiled HLO."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as ref_get_config
    from repro.launch import hlo_analysis
    from repro.models import forward as ref_forward
    from repro.models import init_params as ref_init
    from repro_torch.models import forward, params_from_reference

    ref_cfg = dataclasses.replace(ref_get_config("llama3.2-1b").reduced(),
                                  n_layers=2)
    cfg = dataclasses.replace(get_config("llama3.2-1b").reduced(), n_layers=2)
    params = ref_init(jax.random.PRNGKey(0), ref_cfg)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 64)).astype(np.int32)
    fn = jax.jit(lambda p, x: ref_forward(ref_cfg, p, x, mode="prefill")[0])
    txt = fn.lower(params, jnp.asarray(toks)).compile().as_text()
    want = hlo_analysis.analyze(txt, 1)["flops"]

    tparams = params_from_reference(jax.tree.map(np.asarray, params), cfg,
                                    device="cpu")
    with torch.no_grad():
        _, got = step_analysis.analyze(
            forward, cfg, tparams, torch.from_numpy(toks).long(),
            mode="prefill")
    assert want > 0
    assert abs(got["flops"] - want) <= 0.05 * want, (got["flops"], want)


def test_step_analysis_counts_products_and_skips_views():
    a, b = torch.randn(3, 5, 7), torch.randn(3, 7, 2)
    with step_analysis.StepAnalysis() as an:
        c = torch.bmm(a, b)
        c.view(-1)
        torch.mm(a[0], b[0])
    res = an.result()
    assert res["flops"] == 2 * 3 * 5 * 2 * 7 + 2 * 5 * 2 * 7
    # the bmm reads a and b and writes c; the mm reads its operands' views
    # (their own sizes) and writes its result; the views move nothing
    assert res["bytes"] == 4 * ((105 + 42 + 30) + (35 + 14 + 10))
    assert res["collective_bytes"] == 0


@pytest.mark.parametrize("n_devices", [256, 512])
@pytest.mark.parametrize("shape", SHAPE_NAMES)
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_model_flops_per_device_equal_reference(arch, shape, n_devices):
    from repro.launch import roofline as ref_roofline

    assert (roofline.model_flops_per_device(arch, shape, n_devices)
            == ref_roofline.model_flops_per_device(arch, shape, n_devices))


RECORDS = [
    {"arch": "llama3.2-1b", "shape": "train_4k", "mesh": "16x16", "ok": True,
     "microbatches": 1, "memory": {"total_hbm_bytes": 7.5e9},
     "hlo": {"flops": 3.1e13, "bytes": 2.2e10, "collective_bytes": 1.0e9}},
    {"arch": "gemma3-4b", "shape": "decode_32k", "mesh": "2x16x16", "ok": True,
     "microbatches": 1, "memory": {"total_hbm_bytes": 2.5e10},
     "hlo": {"flops": 2.0e10, "bytes": 9.0e10, "collective_bytes": 1.0e8}},
    {"arch": "rwkv6-3b", "shape": "long_500k", "mesh": "16x16", "ok": True,
     "microbatches": 1, "memory": {"total_hbm_bytes": 1.0e9},
     "hlo": {"flops": 1.0e9, "bytes": 1.0e9, "collective_bytes": 9.0e10}},
    {"arch": "hubert-xlarge", "shape": "decode_32k", "mesh": "16x16",
     "ok": False, "error": "SKIP: encoder-only"},
]


def test_roofline_rows_equal_reference_with_equal_constants(monkeypatch):
    from repro.launch import mesh as ref_mesh
    from repro.launch import roofline as ref_roofline

    monkeypatch.setattr(roofline, "PEAK_FLOPS_BF16", ref_mesh.PEAK_FLOPS_BF16)
    monkeypatch.setattr(roofline, "HBM_BW", ref_mesh.HBM_BW)
    monkeypatch.setattr(roofline, "LINK_BW", ref_mesh.ICI_BW_PER_LINK)
    got = roofline.roofline_rows(RECORDS)
    want = ref_roofline.roofline_rows(RECORDS)
    assert len(got) == len(want) == len(RECORDS)
    for g, w in zip(got, want):
        assert {k: v for k, v in g.items() if k != "hint"} == \
               {k: v for k, v in w.items() if k != "hint"}
        assert ("hint" in g) == ("hint" in w)
    assert {r["dominant"] for r in got if "dominant" in r} == {
        "compute", "memory", "collective"}
    md = roofline.to_markdown(got)
    assert md.count("\n") == len(RECORDS) + 1 and "skipped" in md


def test_roofline_hints_name_this_cards_remedies():
    for dom in ("compute", "memory", "collective"):
        for ratio in (0.1, 0.9):
            text = roofline.hint(dom, "a", "s", ratio)
            assert "VMEM" not in text and "Pallas" not in text
    assert "CUDA flash kernel" in roofline.hint("compute", "a", "s", 0.9)


def test_skipped_cell_reports_its_reason():
    r = dryrun.run_cell("hubert-xlarge", "decode_32k", False, device="cpu")
    assert not r.ok and r.error.startswith("SKIP")


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.run_cell("llama3.2-1b", "train_4k", False, device="cuda")


# ---------------------------------------------------------------------------
# ROADMAP Queue 3 (l), (m), (o): prefill outputs placed, the pure-bf16
# train step's memory, the scan mixers' cells
# ---------------------------------------------------------------------------

def _fake_mesh():
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.mesh import init_fake_world

    init_fake_world(8)
    return init_device_mesh("cpu", tuple(MESH.values()),
                            mesh_dim_names=tuple(MESH))


@pytest.mark.parametrize("arch", ["llama3.2-1b", "hubert-xlarge"])
def test_prefill_output_bytes_equal_reference_rules(arch):
    """(l) The prefill's outputs leave as the reference's ``out_shardings``
    place them: a decoder's last-row logits over ("batch", "vocab") and its
    caches over ``cache_axes``, an encoder's logits over ("batch", "seq",
    "vocab")."""
    from repro.configs import get_config as ref_get_config
    from repro.configs.base import ShapeConfig as RefShape
    from repro.launch.dryrun import rules_for as ref_rules_for
    from repro.models.transformer import cache_schema

    name, seq, batch = SHAPES["prefill"]
    ref_cfg = ref_get_config(arch).reduced()
    rules = ref_rules_for(ref_cfg, RefShape(name, seq, batch, "prefill"),
                          False)
    cfg = get_config(arch).reduced()
    memory, _, _ = dryrun.trace_cell(
        cfg, _shape("prefill"), _fake_mesh(),
        dryrun.rules_for(cfg, _shape("prefill"), False), torch.device("cpu"))
    f32 = np.dtype(np.float32)
    if cfg.encoder_only:
        want = _implied_bytes(rules, {"l": ((batch, seq, cfg.vocab),
                                            ("batch", "seq", "vocab"))},
                              lambda _p: f32)
    else:
        want = _implied_bytes(rules, {"l": ((batch, cfg.vocab),
                                            ("batch", "vocab"))},
                              lambda _p: f32)
        want += _implied_bytes(rules, _leaves(cache_schema(ref_cfg, batch, seq)),
                               lambda _p: f32)
    assert memory["output_size_in_bytes"] == want


def _pure_bf16_cell(n_layers, monkeypatch):
    """(memory, hlo, cfg) of a pure-bf16 Adafactor train step with bf16
    gradient accumulation (nemotron-4-340b's recipe) at ``n_layers``, wide
    enough that Adafactor factors the stacked products."""
    make = dryrun.make_train_step
    monkeypatch.setattr(dryrun, "make_train_step", lambda *a, **k: make(
        *a, **dict(k, accum_dtype="bfloat16")))
    cfg = dataclasses.replace(
        get_config("nemotron-4-340b").reduced(), n_layers=n_layers,
        d_model=256, d_ff=512, n_heads=16, n_kv_heads=8, head_dim=16,
        vocab=512, param_dtype="bfloat16", act_dtype="bfloat16")
    assert cfg.pure_bf16 and cfg.optimizer == "adafactor"
    memory, hlo, _ = dryrun.trace_cell(
        cfg, _shape("train"), _fake_mesh(),
        dryrun.rules_for(cfg, _shape("train"), False), torch.device("cpu"),
        mb_override=2)
    return memory, hlo, cfg


@pytest.mark.parametrize("n_layers", [4, 8])
def test_pure_bf16_train_step_holds_no_whole_f32_stacks(n_layers, monkeypatch):
    """(m) No float32 tensor spanning the layer axis is larger than a
    stacked leaf's own shard (the optimizer works on each leaf where it
    lies), and the step's own tensors peak below 4 x the layers x one
    layer's gradient in float32 (the parent's step held ~11.7x: Adafactor's
    whole [L, rows, cols] second moment on every rank)."""
    from repro.configs import get_config as ref_get_config
    from repro.configs.base import ShapeConfig as RefShape
    from repro.launch.dryrun import rules_for as ref_rules_for
    from repro.models.transformer import model_schema

    memory, hlo, cfg = _pure_bf16_cell(n_layers, monkeypatch)
    ref_cfg = dataclasses.replace(
        ref_get_config("nemotron-4-340b").reduced(), n_layers=n_layers,
        d_model=256, d_ff=512, n_heads=16, n_kv_heads=8, head_dim=16,
        vocab=512)
    name, seq, batch = SHAPES["train"]
    rules = ref_rules_for(ref_cfg, RefShape(name, seq, batch, "train"), False)
    stacked = {p: v for p, v in _leaves(model_schema(ref_cfg)).items()
               if p[0] == "blocks"}
    f32 = np.dtype(np.float32)
    shard_elems = max(_implied_bytes(rules, {p: v}, lambda _p: f32) // 4
                      for p, v in stacked.items())
    for nbytes, op, shape in hlo["largest_outputs"]:
        if shape and shape[0] == n_layers and nbytes == 4 * math.prod(shape):
            assert math.prod(shape) <= shard_elems, (op, shape)
    layer_grad_f32 = _implied_bytes(rules, stacked, lambda _p: f32) / n_layers
    assert memory["temp_size_in_bytes"] <= 4 * n_layers * layer_grad_f32


@pytest.mark.parametrize("kind", ["train", "prefill"])
@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "rwkv6-3b"])
def test_scan_mixer_cells_trace_on_local_shards(arch, kind):
    """(o) The Mamba and RWKV6 cells trace on the fake mesh, their scans
    run on each rank's shards: a few hundred ops a chunk at most, where a
    step-by-step loop on DTensors dispatched thousands."""
    cfg = get_config(arch).reduced()
    memory, hlo, _ = dryrun.trace_cell(
        cfg, _shape(kind), _fake_mesh(), dryrun.rules_for(
            cfg, _shape(kind), False), torch.device("cpu"),
        mb_override=2 if kind == "train" else None)
    assert hlo["flops"] > 0 and hlo["collective_bytes"] > 0
    assert memory["total_hbm_bytes"] >= memory["argument_size_in_bytes"] > 0
