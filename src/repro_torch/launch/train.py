"""End-to-end training driver.

    PYTHONPATH=src python -m repro_torch.launch.train              # on the card
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --steps 50 --batch 8 --seq 128 --checkpoint-every 20
    PYTHONPATH=src python -m repro_torch.launch.train --full       # full width

The port of ``repro.launch.train``, with the same flags plus ``--device``
(default ``cuda``): model zoo -> train step -> SkyStore-backed data pipeline
+ multi-region checkpointing.  ``--reduced`` is on by default, as in the
reference, and ``--full`` runs the model at full width.  The store is built
as the reference builds it (three regions on filesystem backends) on
``--device``, where its controller refreshes.
"""

from __future__ import annotations

import argparse
import tempfile
import time

import numpy as np
import torch

from ..configs import ARCH_NAMES, get_config
from ..core import VirtualStore, make_backends, pick_regions
from ..kernels.ops import resolve_device
from ..models import init_params
from ..train import (
    CheckpointManager, SkyStoreShardSource, SyntheticTokens,
    init_train_state, make_optimizer, make_train_step,
)


def frontend_frames(cfg, tokens: np.ndarray) -> np.ndarray:
    """The modality frontend stub (as in the reference's launcher): token ids
    ``[B, S]`` hashed into fake frame embeddings ``[B, S, frontend_dim]``
    through a table drawn from ``default_rng(0)``."""
    table = np.random.default_rng(0).normal(
        size=(cfg.vocab, cfg.frontend_dim)).astype(np.float32)
    return np.take(table, tokens, axis=0)


def build_store(root: str, device="cuda"):
    cat = pick_regions(3)
    backends = make_backends(list(cat.region_names()), "fs", root=root)
    store = VirtualStore(cat, backends, mode="FB", device=device)
    return cat, store


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train",
                                 description="Train through the SkyStore store.")
    ap.add_argument("--arch", choices=ARCH_NAMES, default="llama3.2-1b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument("--store-root", default=None)
    ap.add_argument("--use-skystore-data", action="store_true")
    ap.add_argument("--base-region", default="aws:us-east-1")
    ap.add_argument("--train-region", default="gcp:us-east1")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    print(f"arch={cfg.name} params~{cfg.param_count():,} device={dev}")

    root = args.store_root or tempfile.mkdtemp(prefix="skystore_")
    cat, store = build_store(root, dev)
    ckpt = None
    if args.checkpoint_every:
        ckpt = CheckpointManager(store, "checkpoints", args.train_region,
                                 name=cfg.name)

    if args.use_skystore_data:
        SkyStoreShardSource.write_corpus(
            store, "corpus", args.base_region, n_shards=8,
            tokens_per_shard=args.batch * (args.seq + 1) * 2,
            vocab=cfg.vocab, seed=args.seed)
        source = SkyStoreShardSource(store, "corpus", args.train_region,
                                     args.batch, args.seq)
    else:
        source = SyntheticTokens(cfg.vocab, args.seq, args.batch, args.seed)

    params = init_params(torch.Generator(device=dev).manual_seed(args.seed), cfg)
    _, opt = make_optimizer(cfg.optimizer, lr=args.lr, warmup_steps=5)
    step_fn = make_train_step(cfg, opt, microbatches=args.microbatches)
    state = init_train_state(cfg, params, opt)

    t0 = time.perf_counter()
    for i, batch in zip(range(args.steps), source):
        if cfg.frontend:
            batch = {"inputs": frontend_frames(cfg, batch["inputs"]),
                     "labels": batch["labels"]}
        tb = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
              for k, v in batch.items()}
        state, metrics = step_fn(state, tb)
        if i % 5 == 0 or i == args.steps - 1:
            print(f"step {i:4d} loss={float(metrics['loss']):.4f} "
                  f"({(time.perf_counter() - t0)/(i+1):.2f}s/step)")
        if ckpt and args.checkpoint_every and (i + 1) % args.checkpoint_every == 0:
            ckpt.save(i + 1, state.params)
            print(f"  checkpointed step {i+1} -> {args.train_region} "
                  f"(transfer so far: ${store.transfers.dollars:.6f})")
    if args.use_skystore_data:
        print("egress paid for data reads:", f"${store.transfers.dollars:.6f}")
        store.run_eviction_scan()
    print("done.")


if __name__ == "__main__":
    main()
