"""Serving driver: batched prefill + decode with the TTL-driven KV tier.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
        --requests 6 --prompt-len 32 --gen 16                  # on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --reduced

The port of ``repro.launch.serve``, with the same flags plus ``--device``.
``--reduced`` is on by default, as in the reference, and ``--no-reduced``
runs the model at full width.  Requests cycle over three distinct prompts,
so the tier sees a miss for each and then hits: a hit reuses the stored
prefill caches and skips the prefill.  Decode writes its caches in place, so
each request decodes on a clone of the tier's caches and a reused prefix
sees the caches its prefill built.
"""

from __future__ import annotations

import argparse
import hashlib
import time

import torch

from ..configs import ARCH_NAMES, get_config
from ..kernels.ops import resolve_device
from ..models import init_params
from ..serve import prefill, serve_step
from ..serve.kv_tier import KVTierManager
from ..tracing import span


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.serve",
        description="Prefill + decode with the TTL-driven KV tier.")
    ap.add_argument("--arch", choices=ARCH_NAMES, default="llama3.2-1b")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap


def make_prompts(cfg, args) -> list:
    """``args.requests`` prompts [batch, prompt_len] on the CPU, cycling over
    three distinct ones drawn from ``args.seed``."""
    distinct = [
        torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                      generator=torch.Generator().manual_seed(args.seed * 3 + i))
        for i in range(3)
    ]
    return [distinct[i % 3] for i in range(args.requests)]


def _clone(tree):
    with span("serve.clone"):
        return _clone_tree(tree)


def _clone_tree(tree):
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    return tree.clone()


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(cfg, params, prompts, gen: int, tier: KVTierManager, dev) -> dict:
    """Serve ``prompts`` in order; returns each request's tokens [B, gen]
    (on the CPU), whether it hit the tier, and its times (host clock, the
    device synchronised)."""
    out = {"tokens": [], "hit": [], "prefill_s": [], "decode_s": [],
           "decode_steps": [], "occupancy": []}
    for prompt in prompts:
        with span("serve.request"):
            _serve_one(cfg, params, prompt, gen, tier, dev, out)
    return out


def _serve_one(cfg, params, prompt, gen: int, tier: KVTierManager, dev,
               out: dict) -> None:
    pkey = "prefix:" + hashlib.blake2b(prompt.numpy().tobytes(),
                                       digest_size=4).hexdigest()
    prompt = prompt.to(dev)
    max_len = prompt.shape[1] + gen
    t0 = time.perf_counter()
    with span("serve.tier"):
        blk = tier.lookup(pkey)
    if blk is None:
        with span("serve.prefill"):
            logits, caches, pos = prefill(cfg, params, prompt, max_len=max_len)
        nbytes = sum(x.numel() * x.element_size()
                     for group in caches.values()
                     for layer in group.values() for x in layer.values())
        with span("serve.tier"):
            tier.insert(pkey, nbytes, payload=(caches, pos))
        caches = _clone(caches)
        steps = 0
    else:
        payload, pos = blk.payload          # KV reuse: skip prefill
        caches = _clone(payload)
        with span("serve.decode_step"):
            logits, caches = serve_step(cfg, params, caches, prompt[:, -1:],
                                        pos - 1)
        steps = 1
    tok = torch.argmax(logits, -1)[:, None]
    _sync(dev)
    t1 = time.perf_counter()
    toks = [tok]
    for _ in range(gen - 1):
        with span("serve.decode_step"):
            logits, caches = serve_step(cfg, params, caches, tok, pos)
        pos = pos + 1
        tok = torch.argmax(logits, -1)[:, None]
        toks.append(tok)
    _sync(dev)
    t2 = time.perf_counter()
    with span("serve.tier"):
        tier.scan()
    out["tokens"].append(torch.cat(toks, dim=1).cpu())
    out["hit"].append(blk is not None)
    out["prefill_s"].append(t1 - t0 if blk is None else None)
    out["decode_s"].append(t2 - t1)
    out["decode_steps"].append(steps + gen - 1)
    out["occupancy"].append(tier.occupancy())


def run(args) -> dict:
    """Build the model and tier from parsed ``args`` and serve."""
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.encoder_only:
        raise SystemExit(f"{cfg.name} is encoder-only: no decode loop")
    params = init_params(torch.Generator(device=dev).manual_seed(args.seed), cfg)
    tier = KVTierManager(device=dev)
    res = serve(cfg, params, make_prompts(cfg, args), args.gen, tier, dev)
    res.update(cfg=cfg, params=params, tier=tier)
    return res


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    res = run(args)
    print("tier break-even residencies (s):", res["tier"].t_even_seconds())
    for i, (hit, occ) in enumerate(zip(res["hit"], res["occupancy"])):
        print(f"req {i}: hit={'yes' if hit else 'no '} "
              f"occupancy={ {k: v // 1024 for k, v in occ.items()} }KB")
    # decode_s times the gen - 1 steps after a request's first token.
    steps = len(res["decode_s"]) * (args.gen - 1)
    decode_s = sum(res["decode_s"])
    if steps:
        print(f"decode: {steps * args.batch} tokens in {decode_s:.3f}s, "
              f"{1e3 * decode_s / steps:.2f} ms a step, "
              f"{steps * args.batch / decode_s:.1f} tokens/s")
    prefill_s = [s for s in res["prefill_s"] if s is not None]
    if prefill_s:
        print(f"prefill: {len(prefill_s)} prompts of {args.prompt_len} "
              f"tokens in {sum(prefill_s):.3f}s")
    print(f"tier stats: {res['tier'].stats}")


if __name__ == "__main__":
    main()
