"""The port's flash-attention op against the JAX package's.

On the CPU the port's wrapper computes the kernel's plain version; the JAX
side runs its Pallas kernel in interpret mode, as ``tests/test_kernels.py``
runs it.  Inputs are drawn with numpy from a seed and rounded to bf16 the
same way on both sides.  Tolerance: the reference sweep's own, 2e-5 in f32
(sums in another order) and 2e-2 in bf16 (the TPU kernel rounds the
pre-scaled q to bf16; the plain version scales fp32 logits).

The CUDA kernel itself is held against the plain version on the card by
``tests/test_torch_flash_attention_cuda.py`` and ``chip_smoke.py``.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as r_ops
from repro.models import layers as r_layers
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.models import layers

TORCH_DTYPE = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}

#: The six cases of tests/test_kernels.py::test_flash_attention_vs_oracle.
CASES = [
    (2, 4, 2, 256, 256, 64, True, 0, jnp.float32),
    (1, 2, 2, 128, 384, 128, False, 0, jnp.float32),
    (1, 4, 1, 1, 512, 64, True, 511, jnp.float32),
    (2, 2, 2, 200, 200, 80, True, 0, jnp.float32),
    (1, 8, 4, 130, 257, 96, True, 0, jnp.float32),
    (2, 4, 4, 256, 256, 64, True, 0, jnp.bfloat16),
]
#: Head dims 192 and 256 (nemotron-4-340b and deepseek's MLA at 192,
#: gemma3-4b at 256), which the TPU wrapper pads to 256 lanes: f32 and bf16,
#: causal and not, at an offset.
LARGE_D_CASES = [
    (1, 4, 2, 130, 130, 192, True, 0, jnp.float32),
    (1, 2, 1, 64, 200, 256, False, 0, jnp.float32),
    (1, 4, 2, 1, 300, 256, True, 299, jnp.float32),
    (1, 4, 2, 100, 230, 192, True, 130, jnp.bfloat16),
    (2, 2, 2, 128, 128, 256, True, 0, jnp.bfloat16),
    (1, 2, 2, 70, 160, 256, False, 0, jnp.bfloat16),
]


def _tol(dtype):
    return 2e-5 if dtype in (jnp.float32, torch.float32) else 2e-2


def _qkv(b, hq, hkv, sq, skv, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, sq, d)).astype(np.float32),
            rng.standard_normal((b, hkv, skv, d)).astype(np.float32),
            rng.standard_normal((b, hkv, skv, d)).astype(np.float32))


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,off,dtype",
                         CASES + LARGE_D_CASES)
def test_plain_op_vs_pallas_kernel(b, hq, hkv, sq, skv, d, causal, off, dtype):
    q, k, v = _qkv(b, hq, hkv, sq, skv, d, seed=b * 31 + sq + skv)
    want = r_ops.flash_attention(
        *(jnp.asarray(x).astype(dtype) for x in (q, k, v)),
        causal=causal, q_offset=off, interpret=True)
    before = fa.flash_attention_bshd.launches
    got = ops.flash_attention(
        *(torch.from_numpy(x).to(TORCH_DTYPE[dtype]) for x in (q, k, v)),
        causal=causal, q_offset=off)
    assert fa.flash_attention_bshd.launches == before   # CPU: no launch
    assert got.dtype == TORCH_DTYPE[dtype] and got.shape == (b, hq, sq, d)
    tol = _tol(dtype)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("s,t,pos,window", [
    (1, 24, 0, None), (1, 24, 13, None), (1, 24, 23, None),
    (9, 9, None, None), (16, 40, None, None),
    (1, 16, 40, 16),       # a ring decode after the ring wrapped
    (1, 16, 9, 16),        # a ring decode before it fills
    (3, 24, 13, None),     # a decode step of three tokens
    (40, 40, None, 16),    # a windowed prefill (window < S)
    (40, 40, None, 45),    # a windowed prefill (window > S)
])
def test_model_calls_map_onto_the_kernels_contract(s, t, pos, window):
    """The model's attention calls, as ``apply_attn``'s kernel path makes
    them (``layers._flash``), equal the reference's ``_sdpa`` calls:
    prefill is causal at q_offset 0 with the layer's window; a decode step
    (of one or more tokens, a ring cache or not) is causal=False with
    ``kv_len = valid_upto + 1``, which the reference writes as
    causal=False, kv_valid=valid_upto."""
    rng = np.random.default_rng(s * 100 + t)
    q = rng.standard_normal((2, s, 4, 8)).astype(np.float32)
    k = rng.standard_normal((2, t, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, t, 2, 8)).astype(np.float32)
    decode = pos is not None
    if decode:
        valid = min(pos, t - 1) if window is not None else pos
        mask = dict(causal=False, kv_valid=valid)
        call = dict(causal=False, q_offset=pos, kv_len=valid + 1)
    else:
        mask = dict(causal=True, window=window)
        call = dict(causal=True, q_offset=0, window=window)
    want = r_layers._sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          **mask)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    kernel_path = layers._flash(tq, tk, tv, softcap=0.0, **call)
    plain_path = layers._sdpa(tq, tk, tv, **mask)
    for got in (kernel_path, plain_path):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


def test_strided_layouts_go_in_without_copies():
    """The op's [B, H, S, D] tensors reach the kernel as views of
    [B, S, H, D]; a sliced cache (the decode path's) is another stride."""
    q, k, v = (torch.from_numpy(x) for x in
               _qkv(2, 4, 2, 5, 40, 64, seed=3))
    cache_k = torch.zeros(3, 2, 48, 2, 64)
    cache_k[1, :, :40] = k.transpose(1, 2)
    cache_v = torch.zeros_like(cache_k)
    cache_v[1, :, :40] = v.transpose(1, 2)
    want = ops.flash_attention(q, k, v, causal=True, q_offset=35)
    got = fa.flash_attention_bshd(q.transpose(1, 2), cache_k[1, :, :40],
                                  cache_v[1, :, :40], causal=True,
                                  q_offset=35)
    torch.testing.assert_close(got.transpose(1, 2), want, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# The split-KV route's arithmetic and the route planner
# ---------------------------------------------------------------------------

#: The decode shape of the serving path at small width: one query position
#: late in a 1056-slot cache, in f32 and bf16.
DECODE_CASES = [
    (2, 8, 2, 1, 1056, 64, True, 1040, jnp.float32),
    (2, 8, 2, 1, 1056, 64, True, 1040, jnp.bfloat16),
]


@functools.lru_cache(maxsize=None)
def _pallas(case):
    """The JAX package's Pallas kernel in interpret mode on a case's inputs."""
    b, hq, hkv, sq, skv, d, causal, off, dtype = case
    q, k, v = _qkv(b, hq, hkv, sq, skv, d, seed=b * 31 + sq + skv)
    out = r_ops.flash_attention(
        *(jnp.asarray(x).astype(dtype) for x in (q, k, v)),
        causal=causal, q_offset=off, interpret=True)
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("splits", [1, 3, 17])
@pytest.mark.parametrize("case", CASES + DECODE_CASES,
                         ids=lambda c: "-".join(map(str, c[:8])) + f"-{c[8].__name__}")
def test_split_kv_plain_vs_pallas_kernel(case, splits):
    """Per-split partials (m, l, acc) merged in split order equal the TPU
    kernel's streaming softmax, whatever the number of splits."""
    b, hq, hkv, sq, skv, d, causal, off, dtype = case
    q, k, v = (torch.from_numpy(x).to(TORCH_DTYPE[dtype]).transpose(1, 2)
               for x in _qkv(b, hq, hkv, sq, skv, d, seed=b * 31 + sq + skv))
    got = fa.plain_split_kv(q, k, v, causal, off, splits).transpose(1, 2)
    assert got.dtype == TORCH_DTYPE[dtype] and got.shape == (b, hq, sq, d)
    tol = _tol(dtype)
    np.testing.assert_allclose(got.float().numpy(), _pallas(case),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("n_live,splits,want", [
    (1041, 9, [(0, 128), (128, 256), (256, 384), (384, 512), (512, 640),
               (640, 768), (768, 896), (896, 1024), (1024, 1041)]),
    (1041, 3, [(0, 384), (384, 768), (768, 1041)]),
    (1041, 1, [(0, 1041)]),
    (65, 2, [(0, 64), (64, 65)]),
    (64, 9, [(0, 64)]),
    (0, 4, [(0, 0)]),
])
def test_split_ranges_are_whole_tiles_and_never_empty(n_live, splits, want):
    got = fa.split_ranges(n_live, splits)
    assert got == want
    assert got[0][0] == 0 and got[-1][1] == n_live
    assert all(a[1] == b[0] for a, b in zip(got, got[1:]))


def _shapes(b, hq, hkv, sq, skv, d, dtype=torch.bfloat16):
    return (torch.empty((b, sq, hq, d), dtype=dtype),
            torch.empty((b, skv, hkv, d), dtype=dtype))


@pytest.mark.parametrize("shape,causal,off,want", [
    # llama3.2-1b serving: prefill, a decode step late in the 1056-slot
    # cache (1041 live keys: 9 splits x 32 heads >= 2 x 132 blocks), the
    # hit request's first step, and a long cache.
    ((4, 32, 8, 1024, 1024, 64), True, 0, ("wgmma", 1)),
    ((4, 32, 8, 1, 1056, 64), True, 1040, ("splitkv", 9)),
    ((4, 32, 8, 1, 1056, 64), True, 1023, ("splitkv", 8)),
    ((4, 32, 8, 1, 8192, 64), True, 8191, ("splitkv", 32)),
    # a step early in a big cache: the splits follow the live keys
    ((4, 32, 8, 1, 1056, 64), True, 10, ("splitkv", 1)),
    # group 7 at D 128 (qwen2-vl-7b 28/4, deepseek-coder-33b 56/8)
    ((2, 28, 4, 333, 333, 128), True, 0, ("wgmma", 1)),
    ((1, 56, 8, 200, 200, 128), True, 0, ("wgmma", 1)),
    ((2, 28, 4, 1, 1056, 128), True, 1000, ("splitkv", 16)),
    # 64 rows per KV head is still a decode; 65 is not
    ((1, 8, 2, 16, 200, 64), True, 150, ("splitkv", 3)),
    ((1, 4, 1, 65, 200, 64), True, 0, ("wgmma", 1)),
    # D 80 / 96 prefill on the padded wgmma tile, causal or not
    ((2, 2, 2, 200, 200, 80), True, 0, ("wgmma", 1)),
    ((1, 8, 4, 130, 257, 96), True, 0, ("wgmma", 1)),
    ((1, 4, 1, 1, 257, 80), True, 256, ("splitkv", 5)),
    # non-causal decode reads every key
    ((2, 8, 2, 1, 300, 64), False, 0, ("splitkv", 5)),
    # hubert-xlarge's encoder (B 4, H 16, S 1024, D 80, not causal)
    ((4, 16, 16, 1024, 1024, 80), False, 0, ("wgmma", 1)),
    ((4, 16, 16, 1000, 1000, 80), False, 0, ("wgmma", 1)),
])
def test_plan_routes_bf16_by_shape(shape, causal, off, want):
    q, k = _shapes(*shape)
    assert fa.plan(q, k, causal, off) == want


@pytest.mark.parametrize("shape", [(4, 32, 8, 1024, 1024, 64),
                                   (4, 32, 8, 1, 1056, 64),
                                   (2, 2, 2, 200, 200, 80),
                                   (1, 8, 4, 130, 257, 96),
                                   (1, 32, 8, 256, 256, 64)])
def test_plan_sends_float32_to_the_cuda_core_route(shape):
    """f32 keeps the reference's 2e-5 tolerance only with f32 products."""
    q, k = _shapes(*shape, dtype=torch.float32)
    assert fa.plan(q, k, True, 0) == ("simt", 1)


@pytest.mark.parametrize("route,dtype", [("simt", torch.bfloat16),
                                         ("wgmma", torch.float32),
                                         ("splitkv", torch.float32)])
def test_routes_refuse_the_other_dtype(route, dtype):
    """``simt`` takes float32 only; the tensor-core routes bf16 only."""
    q, k = _shapes(1, 4, 4, 8, 8, 64, dtype=dtype)
    with pytest.raises(TypeError, match=f"the {route} route takes"):
        fa._check_route(route, q, k)


#: Non-causal D 80 / 96 prefill (hubert-xlarge's encoder calls, at small
#: width), in f32 and bf16.
PADDED_CASES = [
    (2, 4, 4, 200, 200, 80, False, 0, jnp.float32),
    (2, 4, 4, 200, 200, 80, False, 0, jnp.bfloat16),
    (1, 8, 4, 130, 257, 96, True, 0, jnp.bfloat16),
    (1, 4, 2, 100, 100, 96, False, 0, jnp.float32),
]


def _plain_padded(q, k, v, causal, q_offset):
    """The padded tile's arithmetic in plain PyTorch: q, k and v
    zero-padded to two 64-column atoms (128 columns), the true D's softmax
    scale, the padded columns of the output dropped."""
    d = q.shape[-1]
    pad = [0, 128 - d]
    out = fa.plain(*(torch.nn.functional.pad(t, pad) for t in (q, k, v)),
                   causal, q_offset, scale=fa.softmax_scale(d))
    return out[..., :d]


@pytest.mark.parametrize("case", PADDED_CASES,
                         ids=lambda c: "-".join(map(str, c[:8])) + f"-{c[8].__name__}")
def test_padded_tile_equals_plain_and_pallas_kernel(case):
    """The wgmma route's padded tile at D 80 / 96 (inputs zero-padded to 128
    columns, the true D's scale, the extra columns dropped) is the plain
    version on the unpadded inputs -- to f32 rounding, whose sums run over
    zero columns in another blocking -- and the TPU kernel's result within
    the reference sweep's tolerance."""
    b, hq, hkv, sq, skv, d, causal, off, dtype = case
    q, k, v = (torch.from_numpy(x).to(TORCH_DTYPE[dtype]).transpose(1, 2)
               for x in _qkv(b, hq, hkv, sq, skv, d, seed=b * 31 + sq + skv))
    got = _plain_padded(q, k, v, causal, off)
    want = fa.plain(q, k, v, causal, off)
    assert got.shape == want.shape and got.dtype == want.dtype
    if dtype == jnp.float32:
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    else:   # one bf16 rounding of the output apart at most
        torch.testing.assert_close(got.float(), want.float(),
                                   rtol=2.0 ** -7, atol=2.0 ** -7)
    tol = _tol(dtype)
    np.testing.assert_allclose(got.transpose(1, 2).float().numpy(),
                               _pallas(case), rtol=tol, atol=tol)


def _plain_rounded_q(q, k, v, causal, q_offset):
    """The plain version on q x d**-0.5 rounded to q's dtype first."""
    q = (q.float() * fa.softmax_scale(q.shape[-1])).to(q.dtype)
    return fa.plain(q, k, v, causal, q_offset, scale=1.0)


@pytest.mark.parametrize("scale", [1.0, 5.0, 25.0])
def test_plain_with_rounded_q_is_the_pallas_kernels_function(scale):
    """The TPU wrapper rounds q x d**-0.5 to q's dtype before its kernel,
    and so do the bf16 routes.  Where logits are large that rounding moves
    the argmax of near-tied rows: hubert-xlarge's layer 0 at random init
    has q, k, v of std ~5.2 and logits up to 155 (a one-hot softmax); x25
    reaches logits in the thousands.  So only the plain version on the
    rounded q follows the TPU kernel row for row: each output row within
    2**-5 of its largest |value| (bf16 outputs), at every scale."""
    case = (1, 4, 2, 96, 96, 80, False, 0, jnp.bfloat16)
    q, k, v = (x * np.float32(scale) for x in _qkv(*case[:6], seed=17))
    want = np.asarray(r_ops.flash_attention(
        *(jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v)),
        causal=False, interpret=True), np.float32)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16).transpose(1, 2)
                  for x in (q, k, v))
    got = _plain_rounded_q(tq, tk, tv, False, 0).transpose(1, 2)
    err = np.abs(got.float().numpy() - want)
    row_max = np.abs(want).max(axis=-1, keepdims=True)
    assert (err <= 2.0 ** -5 * row_max).all()
    if scale == 1.0:   # f32 at unit scale: one f32 rounding of q x scale
        f32 = [torch.from_numpy(x).transpose(1, 2) for x in (q, k, v)]
        torch.testing.assert_close(_plain_rounded_q(*f32, False, 0),
                                   fa.plain(*f32, False, 0),
                                   rtol=1e-5, atol=1e-5)


def test_decode_splits_fill_the_card():
    for bh, n_live in ((32, 1041), (32, 8192), (4, 1041), (1, 100), (64, 4096)):
        splits = fa.decode_splits(bh, n_live)
        ranges = fa.split_ranges(n_live, splits)
        assert len(ranges) == splits
        tiles = [-(-(hi - lo) // fa.DECODE_TILE) for lo, hi in ranges]
        assert max(tiles) <= fa.DECODE_MAX_TILES or splits * bh >= 2 * fa.H100_SMS
        assert splits * bh >= min(2 * fa.H100_SMS, bh * -(-n_live // 64))


# ---------------------------------------------------------------------------
# The sliding window and the key count
# ---------------------------------------------------------------------------

#: (Sq, Skv, q_offset, causal, window, kv_len): windows of 1, of S, above S,
#: and not a multiple of 64 at an offset; a decode step's key count, one
#: and three tokens; a window and a key count without the causal mask.
MASKS = [
    (40, 40, 0, True, 1, None),
    (40, 40, 0, True, 40, None),
    (40, 40, 0, True, 100, None),
    (70, 200, 130, True, 65, None),
    (200, 200, 0, True, 129, None),
    (1, 120, 100, False, None, 101),
    (3, 120, 100, False, None, 101),
    (50, 130, 0, False, 77, 110),
    (16, 300, 200, True, 70, None),
]


@pytest.mark.parametrize("case", MASKS, ids=lambda c: "-".join(map(str, c)))
def test_masks_equal_the_references_sdpa(case):
    """``window`` and ``kv_len`` in every plain version (``plain``,
    ``plain_split_kv`` over several splits, ``ref.mha_ref``) are the
    reference ``_sdpa``'s ``window`` and ``kv_valid = kv_len - 1`` masks,
    within 1e-5 in f32."""
    sq, skv, off, causal, window, kv_len = case
    rng = np.random.default_rng(sq * 7 + skv)
    q = rng.standard_normal((2, sq, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, skv, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, skv, 2, 16)).astype(np.float32)
    want = np.asarray(r_layers._sdpa(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, q_offset=off,
        kv_valid=None if kv_len is None else kv_len - 1))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    masks = dict(window=window, kv_len=kv_len)
    got = {"plain": fa.plain(tq, tk, tv, causal, off, **masks),
           "mha_ref": ref.mha_ref(
               tq.transpose(1, 2), tk.repeat_interleave(2, 2).transpose(1, 2),
               tv.repeat_interleave(2, 2).transpose(1, 2), causal=causal,
               q_offset=off, **masks).transpose(1, 2),
           "entry": fa.flash_attention_bshd(tq, tk, tv, causal, off,
                                            **masks)}
    for splits in (1, 2, 5):
        got[f"split_kv/{splits}"] = fa.plain_split_kv(tq, tk, tv, causal, off,
                                                      splits, **masks)
    for name, out in got.items():
        np.testing.assert_allclose(out.numpy(), want, rtol=1e-5, atol=1e-5,
                                   err_msg=name)


def test_masks_are_checked():
    q = torch.zeros(1, 4, 2, 64)
    for bad in (dict(window=0), dict(window=-3), dict(kv_len=-1),
                dict(window=2.5)):
        with pytest.raises(ValueError):
            fa.flash_attention_bshd(q, q, q, **bad)


@pytest.mark.parametrize("n_live,splits,lo,want", [
    (2071, 9, 1048, [(1024, 1152), (1152, 1280), (1280, 1408), (1408, 1536),
                     (1536, 1664), (1664, 1792), (1792, 1920), (1920, 2048),
                     (2048, 2071)]),
    (2071, 4, 1048, [(1024, 1344), (1344, 1664), (1664, 1984),
                     (1984, 2071)]),
    (300, 3, 200, [(192, 256), (256, 300)]),
    (300, 1, 0, [(0, 300)]),
])
def test_split_ranges_start_at_the_windows_tile(n_live, splits, lo, want):
    """With a window the splits cover the tiles from the one holding the
    least live key on; keys below it in that tile are masked."""
    got = fa.split_ranges(n_live, splits, lo)
    assert got == want
    assert all(a[1] == b[0] for a, b in zip(got, got[1:]))


@pytest.mark.parametrize("shape,causal,off,window,kv_len,want", [
    # gemma3-4b: windowed prefill, a ring decode (1,024 slots filled), a
    # global layer's decode at position 2,070 of a 2,080-slot cache
    ((4, 8, 4, 2048, 2048, 256), True, 0, 1024, None, ("wgmma", 1)),
    ((4, 8, 4, 1, 1024, 256), False, 2070, None, 1024, ("splitkv", 16)),
    ((4, 8, 4, 1, 2080, 256), False, 2070, None, 2071, ("splitkv", 17)),
    # a windowed decode chunk: only the window's tiles are split
    ((4, 8, 4, 1, 2080, 256), True, 2070, 1024, None, ("splitkv", 17)),
    # nemotron-4-340b (96 / 8 heads of 192): prefill and decode
    ((1, 96, 8, 1024, 1024, 192), True, 0, None, None, ("wgmma", 1)),
    ((1, 96, 8, 1, 1056, 192), True, 1040, None, None, ("splitkv", 17)),
    # deepseek-v2-lite-16b's MLA prefill (16 heads, Dk 192)
    ((2, 16, 16, 1024, 1024, 192), True, 0, None, None, ("wgmma", 1)),
])
def test_plan_takes_large_head_dims_and_masks(shape, causal, off, window,
                                              kv_len, want):
    q, k = _shapes(*shape)
    assert fa.plan(q, k, causal, off, window=window, kv_len=kv_len) == want
    route = want[0]
    fa._check(q, k, k)
    fa._check_route(route, q, k)


@pytest.mark.parametrize("d", [192, 256])
def test_check_takes_the_new_head_dims(d):
    q, k = _shapes(1, 4, 2, 128, 128, d)
    fa._check(q, k, k)
    for route in ("wgmma", "splitkv"):
        fa._check_route(route, q[:, :1] if route == "splitkv" else q, k)
    fa._check_route("simt", q.float(), k.float())
    wide, _ = _shapes(1, 4, 2, 128, 128, 320)
    with pytest.raises(ValueError, match="head dim 320"):
        fa._check(wide, wide[:, :, :2], wide[:, :, :2])
