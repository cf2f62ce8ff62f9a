"""Training on the card, and the card halves of two closed faults.

A CUDA kernel has no CPU mode, so every test here needs an NVIDIA Hopper
card and skips itself without one.  The file imports only the port (no JAX):

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_train_cuda.py

- Train-mode gradients on the card (plain attention, as the train step
  takes it) against the CPU port's from the same params and batch, f32 with
  TF32 off: the loss within 1e-5 relative, each gradient leaf within 1e-4
  of its largest |value|.
- Attention that needs a gradient raises on the card instead of going
  through the forward-only kernel; under ``torch.no_grad()`` the same
  forward launches it, once a layer.
- A reduced config's head dim 8, zero-padded to 64 on the ``simt`` route,
  against ``plain()`` at the true scale (2e-5), in prefill and decode.
- ``python -m repro_torch.launch.serve`` and ``python -m
  repro_torch.launch.train`` with their default arguments exit 0 on the
  card.
- hubert-xlarge's eval step at full width (d 1280, 16 heads, head dim 80,
  not causal, bf16) cut to 2 layers, on frames from the frontend stub: one
  ``wgmma`` launch a layer and no ``simt``; the bf16 loss through the kernel
  no further from the f32 plain loss than 1.5x the plain bf16 loss is (or
  1e-3 of it), the rule of ``chip_smoke.py``'s eval gates.
"""

import dataclasses

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch.train import frontend_frames
from repro_torch.models import forward, init_params, layers, loss_fn
from repro_torch.train import make_eval_step
from repro_torch.tree import leaves, leaves_with_path, tree_map, unflatten

pytestmark = pytest.mark.cuda

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def card():
    if (not torch.cuda.is_available()
            or torch.cuda.get_device_capability() < (9, 0)):
        pytest.skip("needs an NVIDIA Hopper card: the CUDA kernel is built "
                    "for sm_90a and has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _batch(vocab, b, s, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (b, s + 1), dtype=np.int32)
    return {"inputs": torch.from_numpy(toks[:, :-1]),
            "labels": torch.from_numpy(toks[:, 1:])}


def _grads(cfg, params, batch):
    leaf = [p.detach().requires_grad_(True) for p in leaves(params)]
    loss, _ = loss_fn(cfg, unflatten(params, leaf), batch,
                      plain_attention=True)
    return float(loss.detach()), torch.autograd.grad(loss, leaf)


@pytest.mark.parametrize("s", [16, 1024])
def test_train_gradients_on_card_match_cpu(card, s):
    cfg = get_config("llama3.2-1b").reduced()
    params = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    batch = _batch(cfg.vocab, 2, s, seed=s)
    loss_cpu, g_cpu = _grads(cfg, params, batch)
    loss_gpu, g_gpu = _grads(cfg, tree_map(lambda t: t.to(card), params),
                             {k: v.to(card) for k, v in batch.items()})
    assert abs(loss_gpu - loss_cpu) <= 1e-5 * abs(loss_cpu)
    for (path, _), a, b in zip(leaves_with_path(params), g_gpu, g_cpu):
        err = float((a.cpu() - b).abs().max())
        assert err <= 1e-4 * float(b.abs().max()), path


def test_attention_needing_a_gradient_raises_on_card(card):
    cfg = get_config("llama3.2-1b").reduced()
    params = init_params(torch.Generator(device=card).manual_seed(1), cfg)
    toks = torch.randint(0, cfg.vocab, (2, 16), device=card,
                         generator=torch.Generator(device=card).manual_seed(2))
    grad_params = tree_map(lambda t: t.detach().requires_grad_(True), params)
    with pytest.raises(NotImplementedError, match="no backward"):
        forward(cfg, grad_params, toks, mode="train")
    before = fa.flash_attention_bshd.route_launches["simt"]
    with torch.no_grad():
        out, _, _ = forward(cfg, grad_params, toks, mode="train")
        want, _, _ = forward(cfg, params, toks, plain_attention=True)
    torch.cuda.synchronize()
    assert fa.flash_attention_bshd.route_launches["simt"] == before + cfg.n_layers
    assert float((out - want).abs().max()) <= 1e-4 * float(want.abs().max())


#: (B, Hq, Hkv, Sq, Skv, q_offset) at head dim 8, f32 (the simt route).
PAD_CASES = [(2, 4, 4, 32, 32, 0), (2, 4, 4, 1, 48, 40), (1, 4, 1, 130, 130, 0)]


@pytest.mark.parametrize("b,hq,hkv,sq,skv,off", PAD_CASES)
def test_padded_head_dim_8_on_simt(card, b, hq, hkv, sq, skv, off):
    rng = np.random.default_rng(sq + skv)
    q, k, v = (torch.from_numpy(rng.standard_normal(sh).astype(np.float32)).to(card)
               for sh in ((b, sq, hq, 8), (b, skv, hkv, 8), (b, skv, hkv, 8)))
    assert fa.plan(torch.nn.functional.pad(q, (0, 56)), k)[0] == "simt"
    before = fa.flash_attention_bshd.route_launches["simt"]
    got = layers._flash(q, k, v, causal=True, q_offset=off, window=None,
                        softcap=0.0)
    want = fa.plain(q, k, v, True, off)
    torch.cuda.synchronize()
    assert fa.flash_attention_bshd.route_launches["simt"] == before + 1
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("module", ["repro_torch.launch.serve",
                                    "repro_torch.launch.train"])
def test_launcher_default_command_runs_on_card(card, module):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-m", module], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]


def test_hubert_eval_step_at_full_width_runs_on_wgmma(card):
    cfg = dataclasses.replace(get_config("hubert-xlarge"), n_layers=2)
    params = init_params(torch.Generator(device=card).manual_seed(0), cfg)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (4, 1025))
    batch = {"inputs": torch.from_numpy(frontend_frames(cfg, toks[:, :-1])).to(card),
             "labels": torch.from_numpy(toks[:, 1:]).to(card)}
    before = dict(fa.flash_attention_bshd.route_launches)
    l_kernel = float(make_eval_step(cfg)(params, batch)["loss"])
    after = fa.flash_attention_bshd.route_launches
    assert {r: after[r] - before[r] for r in fa.ROUTES} == {
        "wgmma": 2, "splitkv": 0, "simt": 0}
    cfg32 = dataclasses.replace(cfg, param_dtype="float32", act_dtype="float32")
    with torch.no_grad():
        l_plain = float(loss_fn(cfg, params, batch, plain_attention=True)[0])
        l_f32 = float(loss_fn(cfg32, tree_map(lambda t: t.float(), params),
                              batch, plain_attention=True)[0])
    limit = max(1.5 * abs(l_plain - l_f32), 1e-3 * l_f32)
    assert np.isfinite(l_kernel) and abs(l_kernel - l_f32) <= limit
