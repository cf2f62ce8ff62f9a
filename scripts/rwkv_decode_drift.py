#!/usr/bin/env python3
"""How far rwkv6-3b's decode step drifts from its full forward, layer by layer.

Run on a card, from the root of a checkout:

    python3 scripts/rwkv_decode_drift.py

For each case (layers, prompt length, activation dtype) it draws the
weights per layer from seed 0 (``init_params(per_layer=True)``), prefills
the prompt, decodes one token and runs the full forward of the extended
sequence, and prints one JSON line: each layer's output at the new
position, decode against full, as max |diff| / max |full|, and the same for
the logits.  The new position opens an RWKV6 chunk, so both paths compute
the same function; what grows is their rounding, amplified by the stack.
"""

import dataclasses
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import forward, init_params  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve import grow_cache  # noqa: E402

CASES = [(32, 1024, "float32"), (32, 64, "float32"), (4, 1024, "float32"),
         (32, 1024, "bfloat16")]


def rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


def drift(n_layers: int, prompt: int, act_dtype: str, dev) -> dict:
    cfg = dataclasses.replace(get_config("rwkv6-3b"), n_layers=n_layers)
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                         per_layer=True)
    cfg = dataclasses.replace(cfg, act_dtype=act_dtype)
    toks = torch.randint(0, cfg.vocab, (2, prompt + 1),
                         generator=torch.Generator().manual_seed(7)).to(dev)
    seen, block = [], T._apply_block

    def recorded(*args, **kwargs):
        out = block(*args, **kwargs)
        seen.append(out[0][:, -1].float().clone())
        return out

    T._apply_block = recorded
    try:
        with torch.no_grad():
            _, caches, _ = forward(cfg, params, toks[:, :prompt], mode="prefill")
            caches = grow_cache(cfg, caches, prompt + 1)
            seen.clear()
            dec = forward(cfg, params, toks[:, prompt:], mode="decode",
                          caches=caches, pos=prompt)[0][:, -1].float()
            dec_h, seen[:] = list(seen), []
            full = forward(cfg, params, toks)[0][:, -1].float()
            full_h = list(seen)
    finally:
        T._apply_block = block
    return {"layers": n_layers, "prompt": prompt, "act_dtype": act_dtype,
            "logits": rel(dec, full),
            "per_layer": [rel(a, b) for a, b in zip(dec_h, full_h)]}


def main() -> int:
    if not torch.cuda.is_available():
        print("rwkv_decode_drift: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    for case in CASES:
        print(json.dumps(drift(*case, dev)), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
