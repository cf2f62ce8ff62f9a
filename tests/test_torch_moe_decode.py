"""The routed MoE path (``kernels.moe_decode``) on the CPU.

The plain routed version against the capacity path the reference defines
(``layers._capacity_moe``), on the reduced qwen2-moe, deepseek-v2-lite and
jamba configs at decode shapes (S 1, B 1-8), where no pair can be dropped:
in float32 normwise within 1e-5 (``max|got - want| <= tol * max|want|``:
the two differ only in the order of their fp32 sums), in bf16 within 2**-6
(the capacity path rounds g, u, h, each expert's output and the shared
expert to bf16, the routed path once at the end) and no farther from an
fp32 run than the capacity path.  Batches where tokens share experts come
from the router (16 pairs over 8 experts at B 8) and from forced routes.
The engagement rule (``layers._takes_routed``) against its definition, and
the path each call takes by its spans.
"""

import dataclasses
import math

import pytest
import torch

from repro_torch import tracing
from repro_torch.configs import get_config
from repro_torch.kernels import moe_decode
from repro_torch.models import layers

ARCHS = ("qwen2-moe-a2.7b", "deepseek-v2-lite-16b", "jamba-v0.1-52b")
F32_TOL, BF16_TOL = 1e-5, 2.0 ** -6
WEIGHTS = ("we_gate", "we_up", "we_down")
SHARED = ("ws_gate", "ws_up", "ws_down")


def _cfg(arch, **moe):
    cfg = get_config(arch).reduced()
    if moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe))
    return cfg


def _params(cfg, seed=0, dtype=torch.float32):
    """An MoE layer's parameters, each drawn with std 1 / sqrt(fan-in)."""
    g = torch.Generator().manual_seed(seed)
    return {name: (torch.randn(spec.shape, generator=g)
                   / math.sqrt(spec.shape[-2])).to(dtype)
            for name, spec in layers.moe_schema(cfg).items()}


def _x(cfg, b, s=1, seed=1, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((b, s, cfg.d_model), generator=g).to(dtype)


def _close(got, want, tol, msg=""):
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    assert err <= tol * scale, f"{msg}: max abs err {err} > {tol} x {scale}"


def _routed(cfg, p, x, route):
    """The plain routed version on ``route``'s pairs, shaped as ``x``."""
    b, s, d = x.shape
    k = cfg.moe.top_k
    shared = [p[n] for n in SHARED] if cfg.moe.n_shared else []
    return moe_decode.routed_moe(
        x.reshape(b * s, d), route.expert.reshape(b * s, k),
        route.gates.reshape(b * s, k), *(p[n] for n in WEIGHTS),
        *shared).reshape(b, s, d)


def _capacity(cfg, p, x, route):
    return layers._capacity_moe(cfg, p, x, x, lambda t: t, route)


def _forced(cfg, expert, gates):
    """A decode step's route (S 1) with the given ``expert`` / ``gates``
    [B, top_k]: every pair kept, as the router's would be; a pair's slot is
    the number of earlier pairs of its token with the same expert."""
    b, k = expert.shape
    onehot = torch.nn.functional.one_hot(expert, cfg.moe.n_routed).float()
    probs = onehot.sum(1, keepdim=True) / k
    slot = (expert[:, :, None] == expert[:, None, :]).tril(-1).sum(-1)
    return layers.MoERoute(probs, gates[:, None], expert, slot,
                           torch.ones_like(expert, dtype=torch.bool), onehot,
                           cfg.moe.top_k)


def _children(fn):
    """The names of the spans ``fn`` records under ``layer.moe``."""
    tracing.reset()
    try:
        with tracing.recording():
            out = fn()
        return out, {s[0] for s in tracing.spans() if s[0].startswith("moe.")}
    finally:
        tracing.reset()


@pytest.mark.parametrize("batch", [1, 2, 4, 8])
@pytest.mark.parametrize("arch", ARCHS)
def test_plain_routed_equals_capacity_path_f32(arch, batch):
    """Decode (S 1) at the full configs' capacity factor: cap = top_k, no
    pair dropped; the routed path (through ``apply_moe``) gives the
    capacity path's output and aux loss."""
    cfg = _cfg(arch, capacity_factor=get_config(arch).moe.capacity_factor)
    p, x = _params(cfg), _x(cfg, batch)
    route = layers.moe_route(cfg, p, x)
    assert route.cap == cfg.moe.top_k and bool(route.keep.all())
    want = _capacity(cfg, p, x, route)
    (got, aux), names = _children(lambda: layers.apply_moe(cfg, p, x))
    assert names == {"moe.route", "moe.routed", "moe.aux"}
    assert got.dtype == torch.float32
    _close(got, want, F32_TOL, arch)
    torch.testing.assert_close(got, _routed(cfg, p, x, route), rtol=0, atol=0)
    assert float(aux) > 0
    if batch == 8:      # 16 pairs over 8 experts: tokens share experts
        assert route.expert.unique().numel() < route.expert.numel()


@pytest.mark.parametrize("arch", ARCHS)
def test_plain_routed_in_bf16_is_no_farther_from_fp32(arch):
    """bf16 weights and activations at B 4: the routed path within 2**-6
    of the capacity path, and no farther than it from the same routes in
    fp32 (the routed path rounds once, the capacity path at every step)."""
    cfg = _cfg(arch, capacity_factor=1.25)
    p32, x32 = _params(cfg, seed=2), _x(cfg, 4, seed=3)
    p16 = {k: v.to(torch.bfloat16) for k, v in p32.items()}
    x16 = x32.to(torch.bfloat16)
    route = layers.moe_route(cfg, p16, x16)
    truth = _routed(cfg, {k: v.float() for k, v in p16.items()},
                    x16.float(), route)
    got = _routed(cfg, p16, x16, route)
    want = _capacity(cfg, p16, x16, route)
    assert got.dtype == want.dtype == torch.bfloat16
    _close(got, want, BF16_TOL, arch)
    err_routed = float((got.float() - truth).abs().max())
    err_capacity = float((want.float() - truth).abs().max())
    assert err_routed <= err_capacity, (err_routed, err_capacity)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch", ARCHS)
def test_forced_routes_with_shared_experts(arch, dtype):
    """Routes set by hand at B 8: expert 3 chosen by every token, expert 5
    by all but one, the rest distinct where they can be; gates uneven."""
    cfg = _cfg(arch)
    k, n_exp = cfg.moe.top_k, cfg.moe.n_routed
    b = 8
    expert = torch.empty((b, k), dtype=torch.long)
    for t in range(b):
        rest = [e for e in range(n_exp) if e not in (3, 5)]
        picks = [3, 5 if t else rest[-1]] + rest[t % len(rest):][:k - 2]
        expert[t] = torch.tensor(picks[:k])
    assert all(len(set(r.tolist())) == k for r in expert)
    gates = torch.softmax(torch.arange(b * k, dtype=torch.float32)
                          .reshape(b, k) / 7, -1)
    route = _forced(cfg, expert, gates)
    p, x = _params(cfg, seed=4, dtype=dtype), _x(cfg, b, seed=5, dtype=dtype)
    got = _routed(cfg, p, x, route)
    want = _capacity(cfg, p, x, route)
    _close(got, want, F32_TOL if dtype == torch.float32 else BF16_TOL, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_a_token_naming_an_expert_twice_counts_each_pair(arch):
    """Rows that repeat an id (the router's top-k never does; a forced
    route may): each pair is its own slot on the capacity path and its own
    term, with its own gate, on the routed one."""
    cfg = _cfg(arch)
    k, n_exp = cfg.moe.top_k, cfg.moe.n_routed
    expert = torch.tensor([[2] * k, [1] + [2] * (k - 1),
                           [(5 + j) % n_exp for j in range(k)]])
    gates = torch.softmax(torch.arange(3 * k, dtype=torch.float32)
                          .reshape(3, k) / 5, -1)
    route = _forced(cfg, expert, gates)
    p, x = _params(cfg, seed=6), _x(cfg, 3, seed=7)
    _close(_routed(cfg, p, x, route), _capacity(cfg, p, x, route), F32_TOL,
           arch)


@pytest.mark.parametrize("bad", [-1, 60])
def test_plain_refuses_ids_outside_the_experts(bad):
    cfg = _cfg("qwen2-moe-a2.7b")
    p, x = _params(cfg), _x(cfg, 2).reshape(2, -1)
    expert = torch.tensor([[0, 1, 2, 3], [4, 5, 6, 7]])
    expert[1, 2] = bad if bad < 0 else cfg.moe.n_routed
    with pytest.raises(ValueError, match="expert ids must lie in"):
        moe_decode.plain(x, expert, torch.full((2, 4), 0.25),
                         *(p[n] for n in WEIGHTS), *(p[n] for n in SHARED))


@pytest.mark.parametrize("arch", ARCHS)
def test_engagement_follows_capacity_grad_and_shapes(arch):
    """``_takes_routed`` exactly when S * top_k <= cap (at the full configs'
    capacity factor: S 1-4 here), and then only without a gradient and
    at widths the kernels take; each call's spans name the path it took."""
    cfg = _cfg(arch, capacity_factor=1.25)
    m = cfg.moe
    p = _params(cfg)
    for s in range(1, 20):
        x = _x(cfg, 2, s)
        cap = max(int(m.capacity_factor * m.top_k * s / m.n_routed),
                  min(8, s * m.top_k))
        routed = s * m.top_k <= cap
        assert layers._takes_routed(cfg, p, x, cap) == routed, s
        _, names = _children(lambda: layers.apply_moe(cfg, p, x))
        assert ("moe.routed" in names) == routed, (s, names)
        assert ("moe.dispatch" in names) == (not routed), (s, names)
    x = _x(cfg, 2)
    assert layers._takes_routed(cfg, p, x, m.top_k)
    with torch.no_grad():
        assert layers._takes_routed(cfg, p, x.requires_grad_(True), m.top_k)
    with torch.enable_grad():
        assert not layers._takes_routed(cfg, p, x, m.top_k)
        leaf = dict(p, we_up=p["we_up"].clone().requires_grad_(True))
        assert not layers._takes_routed(cfg, leaf, _x(cfg, 2), m.top_k)
    narrow = dataclasses.replace(cfg, d_model=36)
    assert not layers._takes_routed(narrow, _params(narrow), _x(narrow, 2),
                                    m.top_k)
    many = _x(cfg, moe_decode.MAX_TOKENS + 1)
    assert not layers._takes_routed(cfg, p, many, m.top_k)


def _dtensor_worker(rank, port, out):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, distribute_tensor

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=rank)
    try:
        mesh = init_device_mesh("cpu", (1,))
        cfg = _cfg("qwen2-moe-a2.7b", capacity_factor=1.25)
        p, x = _params(cfg), _x(cfg, 2)
        dx = distribute_tensor(x, mesh, [Replicate()])
        dp = {k: distribute_tensor(v, mesh, [Replicate()]) for k, v in p.items()}
        k = cfg.moe.top_k
        torch.save([layers._takes_routed(cfg, p, x, k),
                    layers._takes_routed(cfg, p, dx, k),
                    layers._takes_routed(cfg, dp, x, k)], out)
    finally:
        dist.destroy_process_group()


def test_dtensors_keep_the_capacity_path(tmp_path):
    """A decode step's shapes on DTensors (one gloo rank, the input or the
    weights placed) keep the capacity path: the sharded paths run there."""
    import socket

    import torch.multiprocessing as mp

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    out = tmp_path / "takes.pt"
    mp.start_processes(_dtensor_worker, args=(port, str(out)), nprocs=1,
                       start_method="spawn")
    assert torch.load(out) == [True, False, False]


@pytest.mark.parametrize("cf", [1.0, 0.5])
def test_drop_shapes_take_the_capacity_path(cf):
    """The drop tests' shapes (qwen2-moe reduced, B 2, S 64, capacity
    factor 1.0 / 0.5) drop pairs, so they keep the capacity path."""
    cfg = _cfg("qwen2-moe-a2.7b", capacity_factor=cf)
    p, x = _params(cfg), _x(cfg, 2, 64)
    route = layers.moe_route(cfg, p, x)
    assert not bool(route.keep.all())
    assert not layers._takes_routed(cfg, p, x, route.cap)
    (got, _aux), names = _children(lambda: layers.apply_moe(cfg, p, x))
    assert names == {"moe.route", "moe.dispatch", "moe.experts",
                     "moe.combine", "moe.shared", "moe.aux"}
    torch.testing.assert_close(got, _capacity(cfg, p, x, route), rtol=0,
                               atol=0)


def test_fits():
    """The kernels' shapes: widths in whole tiles, bf16 or f32, and a
    pass's x rows (16 d bytes) with the pair lists (8 bytes a pair) within
    the gate / up kernel's shared memory."""
    assert moe_decode.fits(4, 4, 2048, 1408, torch.bfloat16)
    assert moe_decode.fits(4, 2, 4096, 14336, torch.bfloat16)
    assert moe_decode.fits(1024, 4, 4096, 1408, torch.bfloat16)
    assert not moe_decode.fits(4, 4, 2048, 1400, torch.bfloat16)
    assert not moe_decode.fits(4, 4, 2048, 1408, torch.float16)
    assert not moe_decode.fits(moe_decode.MAX_TOKENS + 1, 4, 2048, 1408,
                               torch.bfloat16)
    assert not moe_decode.fits(1024, 8, 8192, 1408, torch.bfloat16)
    assert moe_decode.fits(1, 8, 8192, 1408, torch.bfloat16)


def test_card_path_raises_off_cpu_and_cuda():
    cfg = _cfg("qwen2-moe-a2.7b")
    p, x = _params(cfg, dtype=torch.float32), _x(cfg, 2)
    route = layers.moe_route(cfg, p, x)
    with pytest.raises(ValueError, match="runs on cpu or cuda"):
        moe_decode.routed_moe(
            x.reshape(2, -1).to("meta"), route.expert.reshape(2, -1),
            route.gates.reshape(2, -1), *(p[n] for n in WEIGHTS),
            *(p[n] for n in SHARED))


def test_checks_refuse_what_the_kernels_do_not_take():
    """The card path's checks, on CPU tensors: a wrong dtype, a transposed
    (non-contiguous) weight and a width off the tiles each raise."""
    cfg = _cfg("qwen2-moe-a2.7b")
    p, x = _params(cfg), _x(cfg, 4)
    route = layers.moe_route(cfg, p, x)
    args = [x.reshape(4, -1), route.expert.reshape(4, -1),
            route.gates.reshape(4, -1), *(p[n] for n in WEIGHTS),
            tuple(p[n] for n in SHARED)]
    moe_decode._check(*args)
    for i, bad in ((2, args[2].double()), (3, args[3].transpose(1, 2)),
                   (0, args[0].to(torch.float16))):
        broken = list(args)
        broken[i] = bad
        with pytest.raises(ValueError):
            moe_decode._check(*broken)
