"""The port's GPipe pipeline against the sequential forward and the
reference.

Four gloo ranks (``torch.multiprocessing``, one stage each) run the
reference test's case -- reduced llama3.2-1b at 4 layers, 4 stages, 4
microbatches, tokens [8, 16] -- on the reference's parameters: the
pipelined logits are held to the port's sequential ``forward`` (1e-5) and
to the reference's (1e-4), the loss to the sequential loss (1e-4), and
every rank's gradients (its layer slice, and the embeddings and final norm
it holds whole) to the sequential gradients (1e-3), all finite and not all
zero.
"""

import dataclasses
import os
import socket
import tempfile

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

N_STAGES, N_MB = 4, 4


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _unflat(flat):
    tree = {}
    for path, v in flat.items():
        node = tree
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return tree


def _worker(rank: int, world: int, port: int, tmp: str) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config
    from repro_torch.distributed.pipeline import (
        make_pipelined_forward, pipeline_loss_fn, stage_param_sharding)
    from repro_torch.models import cross_entropy, forward, params_from_reference

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    try:
        data = np.load(os.path.join(tmp, "case.npz"))
        cfg = dataclasses.replace(get_config("llama3.2-1b").reduced(),
                                  n_layers=4)
        ref = _unflat({k[2:]: data[k] for k in data.files
                       if k.startswith("p/")})
        params = params_from_reference(ref, cfg, device="cpu")
        toks = torch.from_numpy(data["tokens"]).long()
        labels = torch.from_numpy(data["labels"]).long()
        mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("stage",))
        local = stage_param_sharding(mesh, params, N_STAGES)

        with torch.no_grad():
            seq_logits, _, _ = forward(cfg, params, toks, mode="train")
            pp_logits = make_pipelined_forward(cfg, mesh, N_STAGES,
                                               N_MB)(local, toks)

        leaves = _flat(local)
        for v in leaves.values():
            v.requires_grad_(True)
        loss = pipeline_loss_fn(cfg, mesh, N_STAGES, N_MB)(
            _unflat(leaves), {"inputs": toks, "labels": labels})
        loss.backward()

        seq_leaves = {k: v.detach().clone().requires_grad_(True)
                      for k, v in _flat(params).items()}
        lg, _, _ = forward(cfg, _unflat(seq_leaves), toks, mode="train")
        seq_loss = cross_entropy(lg, labels)
        seq_loss.backward()

        per = cfg.pattern_repeats() // N_STAGES
        out = {"pp_logits": pp_logits.numpy(),
               "seq_logits": seq_logits.numpy(),
               "loss": loss.detach().numpy(),
               "seq_loss": seq_loss.detach().numpy()}
        for k, v in leaves.items():
            want = seq_leaves[k].grad
            if k.startswith("blocks/"):
                want = want[rank * per:(rank + 1) * per]
            out["g/" + k] = v.grad.numpy()
            out["w/" + k] = want.numpy()
        np.savez(os.path.join(tmp, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def pipeline_run():
    import jax

    from repro.configs import get_config
    from repro.models import forward as ref_forward
    from repro.models import init_params

    cfg = dataclasses.replace(get_config("llama3.2-1b").reduced(), n_layers=4)
    params = init_params(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab, (8, 16)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (8, 16)).astype(np.int32)
    ref_logits, _, _ = ref_forward(cfg, params, toks, mode="train",
                                   remat=False)
    flat = _flat(jax.tree.map(np.asarray, params))
    with tempfile.TemporaryDirectory() as tmp:
        np.savez(os.path.join(tmp, "case.npz"), tokens=toks, labels=labels,
                 **{"p/" + k: v for k, v in flat.items()})
        mp.start_processes(_worker, args=(N_STAGES, _free_port(), tmp),
                           nprocs=N_STAGES, start_method="spawn")
        ranks = [dict(np.load(os.path.join(tmp, f"rank{r}.npz")))
                 for r in range(N_STAGES)]
    return np.asarray(ref_logits), ranks


def test_pipelined_logits_match_sequential_and_reference(pipeline_run):
    ref_logits, ranks = pipeline_run
    for out in ranks:
        assert np.abs(out["pp_logits"] - out["seq_logits"]).max() < 1e-5
        assert np.abs(out["pp_logits"] - ref_logits).max() < 1e-4


def test_pipelined_loss_and_gradients_match_sequential(pipeline_run):
    _, ranks = pipeline_run
    mass = 0.0
    for r, out in enumerate(ranks):
        assert abs(float(out["loss"]) - float(out["seq_loss"])) < 1e-4
        grads = [k for k in out if k.startswith("g/")]
        assert any(k.startswith("g/blocks/") for k in grads)
        for k in grads:
            g, want = out[k], out["w/" + k[2:]]
            assert np.isfinite(g).all(), (r, k)
            assert np.abs(g - want).max() < 1e-3, (r, k)
            mass += float(np.abs(g).sum())
    assert mass > 0


@pytest.mark.parametrize("arch, layers, stages, mb, match", [
    ("gemma3-4b", None, 2, 2, "uniform layer pattern"),
    ("llama3.2-1b", 3, 2, 2, "do not split"),
    ("llama3.2-1b", 4, 4, 2, "M >= S"),
])
def test_pipeline_guards_raise(arch, layers, stages, mb, match):
    from repro_torch.configs import get_config
    from repro_torch.distributed.pipeline import make_pipelined_forward

    cfg = get_config(arch).reduced()
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    with pytest.raises(ValueError, match=match):
        make_pipelined_forward(cfg, None, stages, mb)
