"""Production mesh construction.

The port of ``repro.launch.mesh``.  Single pod: 16 x 16 = 256 ranks, axes
(data, model).  Multi-pod: 2 x 16 x 16 = 512 ranks, axes (pod, data, model).

A :class:`~torch.distributed.device_mesh.DeviceMesh` spans the ranks of the
default process group, so the caller sets that group up first: a real one
(NCCL over the cards this job has) or the fake one of :func:`init_fake_world`,
on which the dry-run traces a 256- or 512-rank step in one process -- the
counterpart of the reference's 512 forced host devices.  Defined as
functions, so importing this module touches no process group.
"""

from __future__ import annotations

import torch.distributed as dist

from ..kernels.ops import resolve_device


def _device_type(device) -> str:
    return resolve_device(device).type


def _mesh(shape, names, device):
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError(
            "no default process group: initialise one first (a real group, "
            "or init_fake_world(n) for a dry-run)")
    n = 1
    for s in shape:
        n *= s
    if dist.get_world_size() != n:
        raise ValueError(f"mesh {shape} needs {n} ranks; the default group "
                         f"has {dist.get_world_size()}")
    return init_device_mesh(_device_type(device), tuple(shape),
                            mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device)


def make_host_mesh(model: int = 1, device="cuda"):
    """A (data, model) mesh over the ranks this job really has."""
    if not dist.is_initialized():
        raise RuntimeError("no default process group: initialise one first")
    n = dist.get_world_size()
    if n % model:
        raise ValueError(f"model axis {model} does not divide {n} ranks")
    return _mesh((n // model, model), ("data", "model"), device)


def init_fake_world(world_size: int) -> None:
    """Make the default process group a fake one of ``world_size`` ranks
    (this process is rank 0; collectives return at once and move nothing).
    A fake group already there is replaced; a real one raises."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("a real process group is up; the fake world "
                               "needs a process of its own")
        if dist.get_world_size() == world_size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", rank=0, world_size=world_size,
                            store=FakeStore())


#: NVIDIA H100 SXM constants used by the roofline (per card, data sheet).
PEAK_FLOPS_BF16 = 989e12          # FLOP/s, dense bf16 tensor cores
HBM_BW = 3.35e12                  # B/s, HBM3
#: B/s a card moves in one direction over the links its collectives cross.
#: An HGX H100 node holds 8 cards on NVLink 4 (450 GB/s a direction); a 16-
#: wide mesh axis, data or model, spans at least two nodes, so every ring
#: along it crosses the node's InfiniBand, one NDR 400 Gb/s port per card
#: (NVIDIA DGX H100 reference architecture) -- a ring runs at its slowest
#: link, so the collective term divides by the 50 GB/s of that port.
LINK_BW = 50e9
