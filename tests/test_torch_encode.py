"""hubert-xlarge's eval step in the port against the JAX package's, on the CPU.

The slice as a whole: the audio encoder (non-causal attention, the frontend
stub's frame embeddings) through ``loss_fn``, ``make_eval_step`` and
``forward``.  Parameters are drawn by the reference (``init_params``),
carried across as numpy (``params_from_reference``); the frame batch comes
from the frontend stub both launchers use (``launch.train``), on tokens drawn
with numpy from a seed.  Both run in float32 on the CPU, where the port's
attention is the plain one.

Tolerances, as ``tests/test_torch_train.py`` and
``tests/test_torch_models.py`` state them: the loss within 1e-5 relative
(the same float32 arithmetic, the frameworks' transcendentals differing in
the last bits); whole-stack outputs within 1e-4 of their largest |value|.

On the card the same eval step runs at full width through the ``wgmma``
route (``tests/test_torch_train_cuda.py``, ``chip_smoke.py``'s ``encode``
phase); the planner's choice for its calls is checked here on shapes.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as r_get_config
from repro.models import forward as r_forward
from repro.models import init_params as r_init_params
from repro.models import loss_fn as r_loss_fn
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch.train import frontend_frames
from repro_torch.models import forward, loss_fn, params_from_reference
from repro_torch.train import make_eval_step

ARCH = "hubert-xlarge"
LOSS_REL, STACK_TOL = 1e-5, 1e-4


def reference_frames(cfg, tokens):
    """The reference launcher's frontend stub, as ``repro.launch.train``
    writes it inline."""
    return np.take(np.random.default_rng(0).normal(
        size=(cfg.vocab, cfg.frontend_dim)).astype(np.float32), tokens, axis=0)


@pytest.fixture(scope="module")
def model():
    """(reference cfg, port cfg, reference params, port params)."""
    r_cfg = r_get_config(ARCH).reduced()
    cfg = get_config(ARCH).reduced()
    rp = r_init_params(jax.random.PRNGKey(7), r_cfg)
    return r_cfg, cfg, rp, params_from_reference(jax.tree.map(np.asarray, rp),
                                                 cfg, device="cpu")


def frame_batch(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s + 1), dtype=np.int32)
    return {"inputs": frontend_frames(cfg, toks[:, :-1]),
            "labels": toks[:, 1:]}


def test_frontend_stub_is_the_references():
    for cfg in (get_config(ARCH), get_config(ARCH).reduced()):
        toks = np.random.default_rng(3).integers(0, cfg.vocab, (2, 33))
        got = frontend_frames(cfg, toks)
        assert got.shape == (2, 33, cfg.frontend_dim)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, reference_frames(cfg, toks))


def test_flash_ab_frontend_stub_is_the_launchers():
    """``scripts/flash_ab.py`` writes the stub out for parent trees that
    lack ``frontend_frames``; its copy must stay the launcher's."""
    path = Path(__file__).resolve().parents[1] / "scripts" / "flash_ab.py"
    spec = importlib.util.spec_from_file_location("flash_ab", path)
    flash_ab = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(flash_ab)
    cfg = get_config(ARCH).reduced()
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (2, 17))
    np.testing.assert_array_equal(flash_ab._frames(cfg, toks),
                                  frontend_frames(cfg, toks))


@pytest.mark.parametrize("s", [16, 1024])
def test_encoder_loss_and_eval_step_match_reference(model, s):
    """S 1024 takes the chunked lm-head path."""
    r_cfg, cfg, rp, tp = model
    batch = frame_batch(cfg, 2, s, seed=s)
    r_loss, r_m = r_loss_fn(r_cfg, rp, {k: jnp.asarray(v)
                                        for k, v in batch.items()})
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        loss, m = loss_fn(cfg, tp, tb)
    ev = make_eval_step(cfg)(tp, tb)
    for got in (float(loss), float(ev["loss"])):
        assert abs(got - float(r_loss)) <= LOSS_REL * abs(float(r_loss))
    assert abs(float(m["ce"]) - float(r_m["ce"])) <= (
        LOSS_REL * abs(float(r_m["ce"])))
    assert float(ev["loss"]) == float(loss)


def test_encoder_outputs_match_reference(model):
    r_cfg, cfg, rp, tp = model
    x = frame_batch(cfg, 2, 48, seed=11)["inputs"]
    want, _, _ = r_forward(r_cfg, rp, jnp.asarray(x), mode="train")
    got, _, _ = forward(cfg, tp, torch.from_numpy(x), mode="train")
    want = np.asarray(want)
    assert got.shape == want.shape
    err = float(np.abs(got.numpy() - want).max())
    assert err <= STACK_TOL * float(np.abs(want).max())


def test_full_width_encoder_calls_plan_the_wgmma_route():
    """Every attention call of the full-width eval step at B 4 x S 1024
    frames (and at a length that is no multiple of 128) goes to ``wgmma``
    in bf16; in f32 it would take ``simt``."""
    cfg = get_config(ARCH)
    d = cfg.resolved_head_dim
    assert (d, cfg.n_heads, cfg.n_kv_heads, cfg.causal) == (80, 16, 16, False)
    for s in (1024, 1000):
        for dtype, route in ((torch.bfloat16, "wgmma"),
                             (torch.float32, "simt")):
            q = torch.empty((4, s, cfg.n_heads, d), dtype=dtype)
            k = torch.empty((4, s, cfg.n_kv_heads, d), dtype=dtype)
            assert fa.plan(q, k, cfg.causal, 0) == (route, 1)
