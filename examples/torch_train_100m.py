"""End-to-end training driver on the port: a ~100M-param llama through the
full stack -- SkyStore-mounted data shards, multi-region checkpoints, a
region-outage drill mid-run, and recovery -- for a few hundred steps, on
``--device`` (default ``cuda``).

    PYTHONPATH=src python examples/torch_train_100m.py --steps 300          # full
    PYTHONPATH=src python examples/torch_train_100m.py --steps 40 --tiny    # smoke
    PYTHONPATH=src python examples/torch_train_100m.py --steps 4 --tiny --device cpu
"""

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import VirtualStore, make_backends, pick_regions
from repro_torch.distributed.fault_tolerance import FleetController, kill_region
from repro_torch.kernels.ops import resolve_device
from repro_torch.models import init_params
from repro_torch.train import (
    CheckpointManager, SkyStoreShardSource, init_train_state, make_optimizer,
    make_train_step,
)
from repro_torch.tree import tree_map

ap = argparse.ArgumentParser()
ap.add_argument("--steps", type=int, default=300)
ap.add_argument("--batch", type=int, default=8)
ap.add_argument("--seq", type=int, default=128)
ap.add_argument("--tiny", action="store_true",
                help="reduced config (CI/smoke); default is ~100M params")
ap.add_argument("--checkpoint-every", type=int, default=50)
ap.add_argument("--fail-at", type=int, default=0,
                help="simulate a region outage at this step (0=off)")
ap.add_argument("--device", default="cuda")
args = ap.parse_args()
dev = resolve_device(args.device)

cfg = get_config("llama3.2-1b")
if args.tiny:
    cfg = cfg.reduced()
else:
    # ~100M-param variant of the llama3.2 family (tied embeddings)
    cfg = dataclasses.replace(
        cfg, n_layers=12, d_model=640, n_heads=10, n_kv_heads=5, head_dim=64,
        d_ff=2560, vocab=50304, act_dtype="float32", param_dtype="float32")
print(f"model: {cfg.name} (~{cfg.param_count()/1e6:.0f}M params)")

cat = pick_regions(3)
base, train_region, spare = cat.region_names()
backends = make_backends(list(cat.region_names()), "memory")
store = VirtualStore(cat, backends, mode="FB", device=dev)

SkyStoreShardSource.write_corpus(
    store, "corpus", base, n_shards=16,
    tokens_per_shard=args.batch * (args.seq + 1) * 4, vocab=cfg.vocab)
source = SkyStoreShardSource(store, "corpus", train_region,
                             args.batch, args.seq)
print(f"corpus: {source.epoch_bytes/2**20:.1f} MiB in {base}; "
      f"training in {train_region}")

params = init_params(torch.Generator(device=dev).manual_seed(0), cfg)
_, opt = make_optimizer("adamw", lr=1e-3, warmup_steps=20)
step_fn = make_train_step(cfg, opt, microbatches=2)
state = init_train_state(cfg, params, opt)
ckpt = CheckpointManager(store, "ckpt", train_region, name="llama100m")
fleet = FleetController(ckpt)


def on_device(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in batch.items()}


fail_at = args.fail_at or (args.steps // 2 if args.steps >= 100 else 0)
t0 = time.time()
i = 0
data_iter = iter(source)
while i < args.steps:
    batch = next(data_iter)
    state, metrics = step_fn(state, on_device(batch))
    i += 1
    if i % max(args.checkpoint_every, 1) == 0:
        ckpt.save(i, state.params)
        # exercise a cross-region restore so replicas exist off-site
        ckpt.restore(step=i, region=spare, like=state.params)
    if i % 20 == 0 or i == 1:
        print(f"step {i:4d} loss={float(metrics['loss']):.4f} "
              f"egress=${store.transfers.dollars:.6f} "
              f"({(time.time()-t0)/i:.2f}s/step)")
    if fail_at and i == fail_at:
        print(f"\n!!! simulated outage of {train_region} at step {i}")
        kill_region(backends, train_region)
        step_no, restored = fleet.recover(like=state.params, into_region=spare)
        state = init_train_state(cfg, tree_map(lambda t: t.to(dev), restored),
                                 opt)
        # rebuild optimizer progress is fresh; data continues in spare region
        source = SkyStoreShardSource(store, "corpus", spare,
                                     args.batch, args.seq)
        data_iter = iter(source)
        print(f"recovered from checkpoint step {step_no}, resuming in "
              f"{spare}; continuing\n")
        fail_at = 0

print(f"\ndone: {args.steps} steps in {time.time()-t0:.0f}s; "
      f"total egress ${store.transfers.dollars:.6f}")
store.run_eviction_scan()
