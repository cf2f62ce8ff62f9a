"""GQA decode's rope and cache write in one call (``kernels.rope_cache``)
on the CPU.

- ``plain`` against ``layers.rotate`` + ``write_seq``, bit for bit, at the
  attention shapes of qwen2-moe-a2.7b (16 / 16 heads of 128, theta 1e6),
  llama3.2-1b (32 / 8 of 64), gemma3-4b (8 / 4 of 256: a ring slot that
  wraps and a global layer), nemotron-4-340b (group 12 at D 192) and a
  YaRN table with a cos / sin scale, at positions up to 16,446, in bf16
  and fp32.
- ``apply_attn``'s decode step with the call and with ``fits`` forced to
  refuse: the same output and caches, bit for bit, on the reduced configs.
- ``fits`` refuses M-RoPE, no rope, S > 1, a gradient, DTensors, other
  dtypes, odd or over-wide head dims.
- A reduced qwen2-moe served through ``launch.serve``: the same tokens and
  decode caches with the call as without; one call an attention layer a
  decode forward, none in prefill; ``launches`` stays 0 on the CPU.
"""

import dataclasses

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.distributed.sharding import write_seq
from repro_torch.kernels import rope_cache
from repro_torch.launch import serve as launch_serve
from repro_torch.models import init_params, layers
from repro_torch.serve.kv_tier import KVTierManager

CPU = torch.device("cpu")

#: (name, arch, Hq, Hkv, D, cache rows, ring (slot = pos % rows), positions)
CASES = [
    ("qwen2-moe", "qwen2-moe-a2.7b", 16, 16, 128, 64, False, (0, 1, 63)),
    ("llama3.2-1b", "llama3.2-1b", 32, 8, 64, 48, False, (0, 17, 47)),
    ("gemma3-ring", "gemma3-4b", 8, 4, 256, 16, True, (5, 37, 2047)),
    ("gemma3-global", "gemma3-4b", 8, 4, 256, 40, False, (0, 39)),
    ("nemotron", "nemotron-4-340b", 24, 2, 192, 32, True, (3, 1031)),
    ("yarn", "llama3.2-1b", 16, 4, 64, 32, True, (0, 2047, 16_446)),
]
DTYPES = (torch.bfloat16, torch.float32)


def _cfg(arch, name):
    cfg = get_config(arch)
    if name == "yarn":
        # deepseek-v2-lite-16b's table; mscale 1 (not mscale_all_dim) so the
        # cos / sin scale is not 1.
        yarn = dataclasses.replace(get_config("deepseek-v2-lite-16b").yarn,
                                   mscale=1.0)
        cfg = dataclasses.replace(cfg, rope_theta=10_000.0, yarn=yarn)
    return cfg


def _inputs(b, hq, hkv, d, rows, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)

    def draw(*shape):
        return torch.randn(shape, generator=g).to(dtype)

    return (draw(b, 1, hq, d), draw(b, 1, hkv, d), draw(b, 1, hkv, d),
            draw(b, rows, hkv, d), draw(b, rows, hkv, d))


def _bits(t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def _same_bits(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        _bits(a), _bits(b))


def _want(cfg, q, k, v, kc, vc, pos, slot):
    """The path the call replaces: ``rotate`` twice, two ``write_seq``."""
    b = q.shape[0]
    positions = (pos + torch.arange(1))[None, :].expand(b, 1)
    q = layers.rotate(cfg, q, positions)
    k = layers.rotate(cfg, k, positions)
    write_seq(kc, slot, k.to(kc.dtype))
    write_seq(vc, slot, v.to(vc.dtype))
    return q


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_plain_equals_rotate_and_write_seq(case, dtype):
    name, arch, hq, hkv, d, rows, ring, positions = case
    cfg = _cfg(arch, name)
    for i, pos in enumerate(positions):
        slot = pos % rows if ring else pos
        q, k, v, kc, vc = _inputs(2, hq, hkv, d, rows, dtype, seed=i)
        kc_w, vc_w = kc.clone(), vc.clone()
        want = _want(cfg, q, k, v, kc_w, vc_w, pos, slot)
        assert rope_cache.fits(cfg.rope, q, k, v, kc, vc)
        inv, scale = layers._rope_table(d, cfg.rope_theta,
                                        getattr(cfg, "yarn", None), CPU)
        assert (scale != 1.0) == (name == "yarn")
        got = rope_cache.rope_cache(q, k, v, kc, vc, pos, slot, inv, scale)
        assert _same_bits(got, want), pos
        assert _same_bits(kc, kc_w) and _same_bits(vc, vc_w), pos
        assert not torch.equal(kc[:, slot], k[:, 0]) or pos == 0
        assert torch.equal(vc[:, slot], v[:, 0])


def _attn_layer(arch, spec_kind, dtype, seed=0):
    """A reduced config's attention layer: (cfg, spec, params)."""
    name = "bfloat16" if dtype == torch.bfloat16 else "float32"
    cfg = dataclasses.replace(get_config(arch).reduced(), act_dtype=name,
                              param_dtype=name)
    spec = next(s for s in cfg.layers() if s.mixer == spec_kind)
    g = torch.Generator().manual_seed(seed)
    p = {k: layers.init_leaf(g, sp, dtype, CPU)
         for k, sp in layers.attn_schema(cfg).items()}
    return cfg, spec, p


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("arch,kind,pos", [
    ("qwen2-moe-a2.7b", "attn", 21), ("llama3.2-1b", "attn", 0),
    ("gemma3-4b", "swa", 13), ("gemma3-4b", "attn", 30),
    ("jamba-v0.1-52b", "attn", 9)])
def test_apply_attn_decode_same_with_and_without_the_call(
        monkeypatch, arch, kind, pos, dtype):
    cfg, spec, p = _attn_layer(arch, kind, dtype)
    b, rows = 3, 32
    rows = spec.window if spec.window else rows
    g = torch.Generator().manual_seed(1)
    x = torch.randn((b, 1, cfg.d_model), generator=g).to(dtype)
    shape = (b, rows, cfg.n_kv_heads, cfg.resolved_head_dim)
    cache = {k: torch.randn(shape, generator=g).to(dtype) for k in "kv"}
    calls = []
    orig = rope_cache.plain
    monkeypatch.setattr(rope_cache, "plain",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    with torch.no_grad():
        got, got_c = layers.apply_attn(
            cfg, p, x, None, spec, mode="decode",
            cache={k: t.clone() for k, t in cache.items()}, pos=pos)
        monkeypatch.setattr(rope_cache, "fits", lambda *a, **k: False)
        want, want_c = layers.apply_attn(cfg, p, x, None, spec, mode="decode",
                                         cache=cache, pos=pos)
    assert calls == [1]
    assert _same_bits(got, want)
    assert all(_same_bits(got_c[k], want_c[k]) for k in "kv")


def _fits_args(dtype=torch.bfloat16, b=2, s=1, hq=4, hkv=2, d=8, rows=6):
    q, k, v, kc, vc = _inputs(b, hq, hkv, d, rows, dtype)
    if s != 1:
        q, k, v = (t.expand(b, s, *t.shape[2:]) for t in (q, k, v))
    return q, k, v, kc, vc


@pytest.mark.parametrize("what", [
    "mrope", "none", "seq2", "grad", "fp16", "f64", "odd_dim", "dim512",
    "cache_heads", "cache_batch", "mixed_dtype"])
def test_fits_refuses(what):
    assert rope_cache.fits("rope", *_fits_args())
    assert rope_cache.fits("rope", *_fits_args(torch.float32, d=256))
    rope, args = "rope", _fits_args()
    if what in ("mrope", "none"):
        rope = what
    elif what == "seq2":
        args = _fits_args(s=2)
    elif what == "grad":
        args = (args[0].clone().requires_grad_(True),) + args[1:]
        with torch.no_grad():
            assert rope_cache.fits(rope, *args)
    elif what in ("fp16", "f64"):
        args = _fits_args(torch.float16 if what == "fp16" else torch.float64)
    elif what == "odd_dim":
        args = _fits_args(d=7)
    elif what == "dim512":
        args = _fits_args(d=512)
    elif what == "cache_heads":
        args = args[:3] + tuple(t[:, :, :1] for t in args[3:])
    elif what == "cache_batch":
        args = args[:3] + tuple(t[:1] for t in args[3:])
    elif what == "mixed_dtype":
        args = args[:4] + (args[4].float(),)
    with torch.enable_grad():
        assert not rope_cache.fits(rope, *args)


def test_the_call_refuses_what_it_cannot_take():
    q, k, v, kc, vc = _fits_args()
    inv, _ = layers._rope_table(8, 1e4, None, CPU)
    with pytest.raises(ValueError, match="outside the cache"):
        rope_cache.rope_cache(q, k, v, kc, vc, 6, 6, inv)
    with pytest.raises(ValueError, match="position -1 < 0"):
        rope_cache.rope_cache(q, k, v, kc, vc, -1, 0, inv)
    with pytest.raises(ValueError, match="runs on cpu or cuda"):
        rope_cache.rope_cache(*(t.to("meta") for t in (q, k, v, kc, vc)), 3,
                              3, inv.to("meta"))


def _dtensor_worker(rank, port, out):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, distribute_tensor

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=rank)
    try:
        mesh = init_device_mesh("cpu", (1,))
        args = _fits_args()
        placed = [distribute_tensor(t, mesh, [Replicate()]) for t in args]
        torch.save([rope_cache.fits("rope", *args),
                    rope_cache.fits("rope", *placed),
                    rope_cache.fits("rope", *args[:3], *placed[3:])], out)
    finally:
        dist.destroy_process_group()


def test_fits_refuses_dtensors(tmp_path):
    """One gloo rank: the inputs or the caches as DTensors keep the
    sharded path (``write_seq``'s per-shard writes)."""
    import socket

    import torch.multiprocessing as mp

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    out = tmp_path / "fits.pt"
    mp.start_processes(_dtensor_worker, args=(port, str(out)), nprocs=1,
                       start_method="spawn")
    assert torch.load(out) == [True, False, False]


def _serve(cfg, params, prompts, gen, monkeypatch, refuse: bool):
    """Tokens, each decode step's returned caches, and the ``plain`` calls
    counted in each prefill and decode forward."""
    counts, caches = [], []
    calls = [0]
    orig_plain = rope_cache.plain
    monkeypatch.setattr(rope_cache, "plain", lambda *a, **k: (
        calls.__setitem__(0, calls[0] + 1) or orig_plain(*a, **k)))
    if refuse:
        monkeypatch.setattr(rope_cache, "fits", lambda *a, **k: False)
    orig_step, orig_prefill = launch_serve.serve_step, launch_serve.prefill

    def step(*a, **k):
        calls[0] = 0
        logits, c = orig_step(*a, **k)
        counts.append(("decode", calls[0]))
        caches.append({g: {n: {key: t.clone() for key, t in layer.items()}
                           for n, layer in grp.items()}
                       for g, grp in c.items()})
        return logits, c

    def prefill(*a, **k):
        calls[0] = 0
        out = orig_prefill(*a, **k)
        counts.append(("prefill", calls[0]))
        return out

    monkeypatch.setattr(launch_serve, "serve_step", step)
    monkeypatch.setattr(launch_serve, "prefill", prefill)
    try:
        with torch.no_grad():
            out = launch_serve.serve(cfg, params, prompts, gen,
                                     KVTierManager(device="cpu"), CPU)
    finally:
        monkeypatch.undo()
    return out, caches, counts


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_served_request_same_with_and_without_the_call(monkeypatch, dtype):
    cfg = dataclasses.replace(get_config("qwen2-moe-a2.7b").reduced(),
                              act_dtype=dtype, param_dtype=dtype)
    params = init_params(torch.Generator().manual_seed(0), cfg,
                         per_layer=True)
    g = torch.Generator().manual_seed(3)
    prompt = torch.randint(0, cfg.vocab, (2, 12), generator=g)
    n_attn = sum(s.mixer in ("attn", "swa") for s in cfg.layers())
    gen = 5
    before = rope_cache.launches
    got, got_c, counts = _serve(cfg, params, [prompt, prompt], gen,
                                monkeypatch, refuse=False)
    want, want_c, none = _serve(cfg, params, [prompt, prompt], gen,
                                monkeypatch, refuse=True)
    assert rope_cache.launches == before
    assert got["hit"] == want["hit"] == [False, True]
    for a, b in zip(got["tokens"], want["tokens"]):
        assert torch.equal(a, b)
    assert counts == ([("prefill", 0)] + [("decode", n_attn)] * (gen - 1)
                      + [("decode", n_attn)] * gen)
    assert all(n == 0 for _, n in none)
    assert len(got_c) == len(want_c) == 2 * gen - 1
    for a, b in zip(got_c, want_c):
        for grp in a:
            for n in a[grp]:
                for key in a[grp][n]:
                    assert _same_bits(a[grp][n][key], b[grp][n][key])
