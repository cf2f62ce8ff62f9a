"""The port's sharding rules against the reference's.

``rules_for`` and ``pick_microbatches`` for every arch x shape x mesh,
``ShardingRules.spec`` and ``_fit_spec`` for every leaf of every config's
``param_axes`` / ``cache_axes`` (on a fake mesh object with ``.shape``, as
``tests/test_sharding_props.py`` does), the axes trees themselves, and the
reference's own rule tests replayed on the port; then the port's DTensor
side: placements, ``logical_sharding`` on a fake 8-rank group, ``shard``
/ ``gather_fsdp`` returning their argument outside a rules context, and,
on four gloo ranks with real data, attention on DTensors (heads, keys and
query rows split) and the reduced llama3.2-1b and qwen2-moe-a2.7b on
DTensors (train logits, the loss, a decode step) against the plain run.
"""

import threading

import pytest
import torch

# Imported as tests/test_rules_behavior.py imports it (its module sets the
# host-device flag before JAX starts; the reference rules need no devices).
from repro.launch.dryrun import pick_microbatches as ref_pick_microbatches
from repro.launch.dryrun import rules_for as ref_rules_for

from repro.configs import get_config as ref_get_config
from repro.configs import get_shape as ref_get_shape
from repro.distributed import sharding as ref_sharding
from repro.models import cache_axes as ref_cache_axes
from repro.models import param_axes as ref_param_axes

from repro_torch.configs import ARCH_NAMES, SHAPE_NAMES, get_config, get_shape
from repro_torch.distributed import sharding as S
from repro_torch.launch.dryrun import pick_microbatches, rules_for
from repro_torch.models import cache_axes, param_axes
from repro_torch.models.transformer import cache_schema, model_schema
from repro_torch.tree import leaves_with_path


class _FakeMesh:
    def __init__(self, shape):
        self.shape = shape


MESHES = {False: _FakeMesh({"data": 16, "model": 16}),
          True: _FakeMesh({"pod": 2, "data": 16, "model": 16})}


def _specs(tree):
    return dict(leaves_with_path(tree, is_leaf=lambda x: hasattr(x, "axes")))


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("shape", SHAPE_NAMES)
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_rules_for_and_microbatches_equal_reference(arch, shape, multi_pod):
    cfg, shp = get_config(arch), get_shape(shape)
    ref_cfg, ref_shp = ref_get_config(arch), ref_get_shape(shape)
    got = rules_for(cfg, shp, multi_pod)
    want = ref_rules_for(ref_cfg, ref_shp, multi_pod)
    assert isinstance(got, S.ShardingRules)
    assert dict(got) == dict(want)
    for dp in (1, 4, 16, 32):
        assert (pick_microbatches(cfg, shp, dp)
                == ref_pick_microbatches(ref_cfg, ref_shp, dp))


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_axes_trees_equal_reference(arch):
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    assert param_axes(cfg) == ref_param_axes(ref_cfg)
    assert cache_axes(cfg, 4, 64) == ref_cache_axes(ref_cfg, 4, 64)


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("shape", SHAPE_NAMES)
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_spec_and_fit_spec_equal_reference_on_every_leaf(arch, shape,
                                                         multi_pod):
    cfg, shp = get_config(arch), get_shape(shape)
    rules = rules_for(cfg, shp, multi_pod)
    ref_rules = ref_rules_for(ref_get_config(arch), ref_get_shape(shape),
                              multi_pod)
    mesh = MESHES[multi_pod]
    b, s = shp.global_batch, shp.seq_len
    leaves = list(_specs(model_schema(cfg)).items())
    leaves += list(_specs(cache_schema(cfg, b, s)).items())
    assert leaves
    for path, sp in leaves:
        spec = rules.spec(sp.axes)
        ref_spec = ref_rules.spec(sp.axes)
        assert spec == tuple(ref_spec), path
        fitted = S._fit_spec(mesh, spec, sp.shape)
        ref_fitted = ref_sharding._fit_spec(mesh, ref_spec, sp.shape)
        assert fitted == tuple(ref_fitted), path


# -- the reference's rule tests, replayed on the port ------------------------

def test_ep_guard_divisibility():
    r = rules_for(get_config("deepseek-v2-lite-16b"), get_shape("train_4k"),
                  False)
    assert r["experts"] == "model" and r["expert_ff"] is None
    r = rules_for(get_config("qwen2-moe-a2.7b"), get_shape("train_4k"), False)
    assert r["experts"] is None and r["expert_ff"] == "model"
    r = rules_for(get_config("jamba-v0.1-52b"), get_shape("train_4k"), False)
    assert r["experts"] == "model"


@pytest.mark.parametrize("arch, expect", [
    ("deepseek-coder-33b", "model"), ("gemma3-4b", "model"),
    ("qwen2-vl-7b", "model"), ("nemotron-4-340b", None),
    ("llama3.2-1b", None)])
def test_attn_q_only_for_unshardeable_heads(arch, expect):
    r = rules_for(get_config(arch), get_shape("train_4k"), False)
    assert r["attn_q"] == expect


def test_decode_cache_sharding_rules():
    r = rules_for(get_config("llama3.2-1b"), get_shape("decode_32k"), False)
    assert r["kv_seq"] == "model"
    r = rules_for(get_config("deepseek-v2-lite-16b"), get_shape("decode_32k"),
                  False)
    assert r["kv_seq"] == "model"
    r = rules_for(get_config("qwen2-moe-a2.7b"), get_shape("decode_32k"),
                  False)
    assert r["kv_seq"] is None


def test_long_context_uses_sequence_parallelism():
    r = rules_for(get_config("rwkv6-3b"), get_shape("long_500k"), False)
    assert r["batch"] is None
    assert r["kv_seq"] == ("data", "model")
    r = S.long_context_rules()
    assert "data" in (r["kv_seq"] if isinstance(r["kv_seq"], tuple)
                      else (r["kv_seq"],))


def test_microbatch_selection():
    assert pick_microbatches(get_config("nemotron-4-340b"),
                             get_shape("train_4k"), 16) == 8
    assert pick_microbatches(get_config("llama3.2-1b"),
                             get_shape("train_4k"), 16) == 1
    assert pick_microbatches(get_config("jamba-v0.1-52b"),
                             get_shape("train_4k"), 16) == 16
    assert pick_microbatches(get_config("nemotron-4-340b"),
                             get_shape("decode_32k"), 16) == 1


def test_fit_spec_drops_nondivisible_axes():
    mesh = _FakeMesh({"data": 16, "model": 16})
    spec = ("data", "model", None)
    assert S._fit_spec(mesh, spec, (32, 56, 7)) == ("data", None, None)
    assert S._fit_spec(mesh, spec, (32, 96, 7)) == ("data", "model", None)


def test_rules_spec_dedups_mesh_axes():
    rules = S.base_rules()
    rules["kv_seq"] = "model"
    rules["kv_heads"] = "model"
    spec = rules.spec(("batch", "kv_seq", "kv_heads", None))
    flat = [a for part in spec if part for a in
            ((part,) if isinstance(part, str) else part)]
    assert flat.count("model") == 1


# -- the DTensor side ----------------------------------------------------------

class _FakeDeviceMesh:
    def __init__(self, names, shape):
        self.mesh_dim_names, self.shape = names, shape


def test_to_placements():
    from torch.distributed.tensor import Replicate, Shard

    mesh = _FakeDeviceMesh(("pod", "data", "model"), (2, 16, 16))
    assert S.axis_sizes(mesh) == {"pod": 2, "data": 16, "model": 16}
    got = S.to_placements(mesh, (("pod", "data"), None, "model"))
    assert got == (Shard(0), Shard(0), Shard(2))
    assert S.to_placements(mesh, ()) == (Replicate(),) * 3
    assert S.replicated(mesh) == (Replicate(),) * 3


def test_no_op_outside_a_rules_context():
    x = torch.randn(4, 8)
    assert S.shard(x, ("batch", "d_model")) is x
    assert S.gather_fsdp(x) is x
    with S.use_rules(S.base_rules()):          # rules without a mesh
        assert S.shard(x, ("batch", "d_model")) is x
        assert S.current_rules() is not None
    assert S.current_rules() is None


def _in_thread(fn):
    out, errs = [], []

    def run():
        try:
            out.append(fn())
        except BaseException as e:        # noqa: BLE001 -- re-raised below
            errs.append(e)

    t = threading.Thread(target=run)
    t.start()
    t.join()
    if errs:
        raise errs[0]
    return out[0]


def test_rules_are_per_thread_and_carried():
    rules, mesh = S.base_rules(), object()
    with S.use_rules(rules, mesh):
        seen = S.carried(lambda: (S.current_rules(), S._CTX.mesh))
        assert _in_thread(S.current_rules) is None
        assert _in_thread(seen) == (rules, mesh)
    assert S.carried(len) is len              # nothing to carry


def test_checkpoint_recompute_sees_the_forwards_rules(monkeypatch):
    """The train forward's checkpointed blocks recompute in the backward,
    which autograd runs on a device thread of its own for CUDA tensors:
    the recompute sees the rules the forward saw.  Here the backward runs
    on another thread by hand, and a spy records what each attention
    tile reads."""
    from repro_torch.models import forward, init_params, layers
    from repro_torch.tree import tree_map

    cfg = get_config("llama3.2-1b").reduced()
    params = tree_map(lambda t: t.requires_grad_(True),
                      init_params(torch.Generator().manual_seed(0), cfg,
                                  device="cpu"))
    toks = torch.randint(0, cfg.vocab, (2, 8),
                         generator=torch.Generator().manual_seed(1))
    seen = []
    monkeypatch.setattr(layers, "current_rules",
                        lambda: seen.append(S.current_rules()) or seen[-1])
    rules = S.base_rules()
    with S.use_rules(rules):
        logits, _, _ = forward(cfg, params, toks, mode="train")
    in_forward = len(seen)
    _in_thread(lambda: logits.float().sum().backward())
    assert in_forward == cfg.n_layers and len(seen) == 2 * in_forward
    assert all(r is rules for r in seen)


def test_flash_refuses_dtensors(fake_mesh):
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.models.layers import _flash

    q = distribute_tensor(torch.randn(2, 4, 2, 8), fake_mesh,
                          [Replicate(), Replicate()])
    with pytest.raises(NotImplementedError, match="plain_attention=True"):
        _flash(q, q, q, causal=True, q_offset=0, softcap=0.0)


def test_plain_helpers_keep_the_plain_numbers():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(6, 5, 11, generator=g)
    idx = torch.randint(0, 11, (6, 5), generator=g)
    assert torch.equal(S.take_last(x, idx),
                       x.gather(-1, idx[..., None])[..., 0])
    mb = S.split_microbatches(x, 3)
    assert torch.equal(mb, x.reshape(3, 2, 5, 11))


@pytest.fixture(scope="module")
def fake_mesh():
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", rank=0, world_size=8, store=FakeStore())
    yield init_device_mesh("cpu", (4, 2), mesh_dim_names=("data", "model"))
    dist.destroy_process_group()


def test_logical_sharding_places_llama_by_the_rules(fake_mesh):
    from torch.distributed.tensor import Replicate, Shard

    cfg = get_config("llama3.2-1b").reduced()
    rules = S.base_rules()
    shapes = {k: v for k, v in _shapes(model_schema(cfg)).items()}
    placed = S.logical_sharding(fake_mesh, rules, param_axes(cfg),
                                _shape_tree(model_schema(cfg)))
    flat = dict(leaves_with_path(placed, is_leaf=lambda x: isinstance(x, tuple)))
    # wq [layers, d (fsdp -> data), heads (model), hd]
    assert flat[("blocks", "pos0", "mixer", "wq")] == (Shard(1), Shard(2))
    # the norm scales replicate
    assert flat[("final_norm", "scale")] == (Replicate(), Replicate())
    assert set(flat) == set(shapes)


def test_shard_and_gather_fsdp_redistribute_dtensors(fake_mesh):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    rules = S.base_rules()
    w = distribute_tensor(torch.zeros(8, 4), fake_mesh, (Shard(0), Shard(1)))
    x = distribute_tensor(torch.zeros(8, 6), fake_mesh,
                          (Replicate(), Replicate()))
    with S.use_rules(rules, fake_mesh):
        assert S.gather_fsdp(w).placements == (Replicate(), Shard(1))
        assert S.shard(x, ("batch", "d_ff")).placements == (Shard(0),
                                                             Shard(1))
        y = S.shard(x, ("batch", None))
        assert S.shard(y, ("batch", None)) is y


def _shapes(schema):
    return {p: sp.shape for p, sp in _specs(schema).items()}


def _shape_tree(schema):
    if hasattr(schema, "shape"):
        return schema.shape
    return {k: _shape_tree(v) for k, v in schema.items()}


# -- attention on DTensors, numerically, on four gloo ranks ---------------------

ATTN_CASES = [
    # (name, q shape, kv heads, q placements, kv placements, masks, rules,
    #  dtype)
    ("gqa_heads_split_kv", (4, 16, 8, 8), 2, ("S0", "S2"), ("S0", "S2"),
     dict(causal=True), {}, torch.float32),
    ("gqa_kv_sliced", (4, 16, 8, 8), 1, ("S0", "S2"), ("S0", "R"),
     dict(causal=True, window=5), {}, torch.float32),
    ("decode_keys_split", (4, 1, 8, 8), 2, ("S0", "S2"), ("S0", "S1"),
     dict(causal=False, kv_valid=20, q_offset=20), {}, torch.float32),
    ("context_parallel_rows", (4, 16, 8, 8), 2, ("S0", "R"), ("S0", "R"),
     dict(causal=True, window=6), {"attn_q": "model"}, torch.float32),
    # bf16, keys split: P is normalised before it is rounded to v's dtype,
    # as _sdpa rounds it
    ("decode_keys_split_bf16", (4, 1, 8, 64), 2, ("S0", "S2"), ("S0", "S1"),
     dict(causal=False, kv_valid=20, q_offset=20), {}, torch.bfloat16),
]

#: f32: summation order only.  bf16: below one bf16 step of the outputs
#: (2^-8 at |o| >= 0.5); rounding P before its normalisation, as a split
#: softmax might, is off by one or two steps in ~45 % of the outputs.
ATTN_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -9}


def _attn_worker(rank, world, port, out_dir):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.distributed import sharding
    from repro_torch.models.layers import _sdpa

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    try:
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        place = {"S0": Shard(0), "S1": Shard(1), "S2": Shard(2),
                 "R": Replicate()}
        errs = {}
        for name, qshape, kvh, qp, kp, masks, rules, dtype in ATTN_CASES:
            g = torch.Generator().manual_seed(7)
            b, s, h, d = qshape
            t = 32 if s == 1 else s
            q = torch.randn(b, s, h, d, generator=g).to(dtype)
            k = torch.randn(b, t, kvh, d, generator=g).to(dtype)
            v = torch.randn(b, t, kvh, d, generator=g).to(dtype)
            want = _sdpa(q, k, v, **masks)
            r = sharding.base_rules()
            r.update(rules)
            with sharding.use_rules(r, mesh):
                got = _sdpa(distribute_tensor(q, mesh, [place[p] for p in qp]),
                            distribute_tensor(k, mesh, [place[p] for p in kp]),
                            distribute_tensor(v, mesh, [place[p] for p in kp]),
                            **masks)
            errs[name] = float((got.full_tensor().float()
                                - want.float()).abs().max())
        torch.save(errs, f"{out_dir}/attn{rank}.pt")
    finally:
        dist.destroy_process_group()


def test_sharded_attention_matches_plain_on_gloo(tmp_path):
    import socket

    import torch.multiprocessing as mp

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    mp.start_processes(_attn_worker, args=(4, port, str(tmp_path)), nprocs=4,
                       start_method="spawn")
    for rank in range(4):
        errs = torch.load(tmp_path / f"attn{rank}.pt")
        assert set(errs) == {c[0] for c in ATTN_CASES}
        for name, *_, dtype in ATTN_CASES:
            assert errs[name] < ATTN_TOL[dtype], (rank, name, errs[name])


# -- the model on DTensors, numerically, on four gloo ranks ---------------------

MODEL_ARCHS = ("llama3.2-1b", "qwen2-moe-a2.7b")


def _place(mesh, rules, tree, axes):
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.tree import tree_map

    return tree_map(lambda x, ax: distribute_tensor(
        x, mesh, S.placements_for(mesh, rules, ax, x.shape)), tree, axes,
        is_leaf=lambda x: isinstance(x, tuple) and not isinstance(x, torch.Tensor))


def _model_worker(rank, world, port, out_dir):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.models import (cache_axes, forward, init_cache,
                                    init_params, loss_fn, param_axes)
    from repro_torch.tree import leaves, tree_map, unflatten

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    try:
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        errs = {}
        for arch in MODEL_ARCHS:
            cfg = get_config(arch).reduced()
            params = init_params(torch.Generator().manual_seed(0), cfg,
                                 device="cpu")
            g = torch.Generator().manual_seed(1)
            toks = torch.randint(0, cfg.vocab, (4, 16), generator=g)
            labels = torch.randint(0, cfg.vocab, (4, 16), generator=g)
            want, _, _ = forward(cfg, params, toks, mode="train")
            flat = [p.clone().requires_grad_(True) for p in leaves(params)]
            want_loss, _ = loss_fn(cfg, unflatten(params, flat),
                                   {"inputs": toks, "labels": labels})
            want_grads = torch.autograd.grad(want_loss, flat)
            cache = tree_map(lambda t: torch.randn(t.shape, generator=g,
                                                   dtype=t.dtype),
                             init_cache(cfg, 4, 32, device="cpu"))
            for kind in ("train", "decode"):
                shape = ShapeConfig("x", 16, 4, kind)
                rules = rules_for(cfg, shape, False)
                sp = _place(mesh, rules, params, param_axes(cfg))
                st = distribute_tensor(toks, mesh,
                                       S.placements_for(mesh, rules,
                                                        ("batch", "seq"),
                                                        toks.shape))
                with implicit_replication(), S.use_rules(rules, mesh):
                    if kind == "train":
                        got, _, _ = forward(cfg, sp, st, mode="train",
                                            plain_attention=True)
                        sl = distribute_tensor(labels, mesh, st.placements)
                        sflat = [p.detach().requires_grad_(True)
                                 for p in leaves(sp)]
                        loss, _ = loss_fn(cfg, unflatten(sp, sflat),
                                          {"inputs": st, "labels": sl},
                                          plain_attention=True)
                        grads = torch.autograd.grad(loss, sflat)
                        errs[f"{arch}/logits"] = float(
                            (got.full_tensor() - want).abs().max())
                        errs[f"{arch}/loss"] = abs(
                            float(loss.full_tensor()) - float(want_loss))
                        # each leaf against its own scale: the ranks'
                        # partial gradients add in another order
                        errs[f"{arch}/grads"] = max(
                            float((g.full_tensor() - w).abs().max())
                            / max(float(w.abs().max()), 1.0)
                            for g, w in zip(grads, want_grads))
                        continue
                    # one decode step at position 5, the caches split by
                    # the decode rules (kv_seq over model)
                    plain_cache = tree_map(lambda t: t.clone(), cache)
                    sc = _place(mesh, rules, tree_map(lambda t: t.clone(),
                                                      cache),
                                cache_axes(cfg, 4, 32))
                    tok = distribute_tensor(toks[:, :1], mesh,
                                            S.placements_for(
                                                mesh, rules, ("batch", None),
                                                (4, 1)))
                    got, sc2, _ = forward(cfg, sp, tok, mode="decode",
                                          caches=sc, pos=5,
                                          plain_attention=True)
                want_d, pc2, _ = forward(cfg, params, toks[:, :1],
                                         mode="decode", caches=plain_cache,
                                         pos=5)
                errs[f"{arch}/decode"] = float(
                    (got.full_tensor() - want_d).abs().max())
                errs[f"{arch}/decode_cache"] = float(
                    (sc2["blocks"]["pos0"]["k"].full_tensor()
                     - pc2["blocks"]["pos0"]["k"]).abs().max())
        torch.save(errs, f"{out_dir}/model{rank}.pt")
    finally:
        dist.destroy_process_group()


def test_sharded_model_matches_plain_on_gloo(tmp_path):
    """The reduced llama3.2-1b and qwen2-moe-a2.7b on DTensors over a
    (2, 2) mesh of gloo ranks, placed by ``rules_for``: train-mode logits,
    the chunked loss (vocab-parallel label pick and logsumexp, MoE
    dispatch on each rank's sequences) and its gradients (each leaf
    within 1e-5 of its largest value, or of 1), and a decode step that
    writes the caches' local shards, against the plain run (1e-5)."""
    import socket

    import torch.multiprocessing as mp

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    mp.start_processes(_model_worker, args=(4, port, str(tmp_path)), nprocs=4,
                       start_method="spawn")
    for rank in range(4):
        errs = torch.load(tmp_path / f"model{rank}.pt")
        assert len(errs) == 5 * len(MODEL_ARCHS), errs
        for name, err in errs.items():
            assert err < 1e-5, (rank, name, err)
