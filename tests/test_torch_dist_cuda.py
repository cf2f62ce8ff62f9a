"""The distribution layer on the card.

NCCL needs a card, the pipelined forward on the card goes through the CUDA
flash kernel (no CPU mode), and the dry-run here traces on fake CUDA
tensors, so every test needs an NVIDIA Hopper card and skips itself without
one.  The file imports only the port (no JAX):

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_dist_cuda.py

- A one-rank NCCL group: ``make_host_mesh()`` is (1, 1) and an all-reduce
  over its data axis returns its input.
- The GPipe schedule at one stage (S 1, M 2) on reduced llama3.2-1b at 4
  layers, f32 with TF32 off, against the sequential forward on the card
  (1e-5), through the kernel in both (one launch a layer a microbatch).
- One dry-run cell (the reduced train step on a fake (4, 2) mesh) on fake
  CUDA tensors: traced, FLOPs and collective bytes above zero, and the
  same counts as the same cell on the CPU; and so a cell that ROADMAP
  Queue 3 (o) repaired, reduced jamba-v0.1-52b's prefill (its Mamba scans
  on each rank's shards).
"""

import dataclasses
import socket

import pytest
import torch

from repro_torch.configs import ShapeConfig, get_config

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if (not torch.cuda.is_available()
            or torch.cuda.get_device_capability() < (9, 0)):
        pytest.skip("needs an NVIDIA Hopper card: NCCL and the CUDA flash "
                    "kernel have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture
def nccl(card):
    import torch.distributed as dist

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    yield card
    dist.destroy_process_group()


def test_one_rank_nccl_host_mesh(nccl):
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh(device="cuda")
    assert tuple(mesh.shape) == (1, 1)
    x = torch.arange(4.0, device=nccl)
    dist.all_reduce(x, group=mesh.get_group("data"))
    assert x.tolist() == [0.0, 1.0, 2.0, 3.0]


def test_one_stage_pipeline_matches_sequential_on_the_card(nccl):
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.distributed.pipeline import (make_pipelined_forward,
                                                  stage_param_sharding)
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import forward, init_params

    cfg = dataclasses.replace(get_config("llama3.2-1b").reduced(), n_layers=4)
    params = init_params(torch.Generator(device=nccl).manual_seed(0), cfg)
    toks = torch.randint(0, cfg.vocab, (4, 64), device=nccl,
                         generator=torch.Generator(device=nccl).manual_seed(1))
    mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("stage",))
    fwd = make_pipelined_forward(cfg, mesh, 1, 2)
    with torch.no_grad():
        fa.reset_launches()
        got = fwd(stage_param_sharding(mesh, params, 1), toks)
        assert fa.flash_attention_bshd.launches == cfg.n_layers * 2
        want, _, _ = forward(cfg, params, toks, mode="train")
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() < 1e-5


def test_dryrun_cell_on_fake_cuda_tensors(card):
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import init_fake_world

    cfg = get_config("llama3.2-1b").reduced()
    shape = ShapeConfig("t16", 16, 8, "train")
    rules = dryrun.rules_for(cfg, shape, False)
    init_fake_world(8)
    got = {}
    for dev in ("cuda", "cpu"):
        mesh = init_device_mesh(dev, (4, 2), mesh_dim_names=("data", "model"))
        got[dev] = dryrun.trace_cell(cfg, shape, mesh, rules,
                                     torch.device(dev), mb_override=2)
    memory, hlo, _ = got["cuda"]
    assert hlo["flops"] > 0 and hlo["collective_bytes"] > 0
    for key in ("flops", "collective_bytes"):
        assert hlo[key] == got["cpu"][1][key]
    assert memory == got["cpu"][0]


def test_repaired_scan_cell_on_fake_cuda_tensors(card):
    """Reduced jamba-v0.1-52b's prefill, its Mamba scans on each rank's
    shards, on fake CUDA tensors: the CPU's counts and bytes."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import init_fake_world

    cfg = get_config("jamba-v0.1-52b").reduced()
    shape = ShapeConfig("p16", 16, 8, "prefill")
    rules = dryrun.rules_for(cfg, shape, False)
    init_fake_world(8)
    got = {}
    for dev in ("cuda", "cpu"):
        mesh = init_device_mesh(dev, (4, 2), mesh_dim_names=("data", "model"))
        got[dev] = dryrun.trace_cell(cfg, shape, mesh, rules,
                                     torch.device(dev))
    memory, hlo, _ = got["cuda"]
    assert hlo["flops"] > 0 and hlo["collective_bytes"] > 0
    for key in ("flops", "collective_bytes"):
        assert hlo[key] == got["cpu"][1][key]
    assert memory == got["cpu"][0]
