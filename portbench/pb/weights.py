"""A served model's weights, made by the benchmark on the device from the
seed: one bf16 buffer for the whole model, filled by a few large normal
draws of a generator on the card, then each leaf (a view of the buffer, in
the layout the program's ``model_schema`` names) scaled to std
1/sqrt(fan-in), the width its product contracts.  Norm scales are 1.

The program and the reference are handed the same tensors.
"""

from __future__ import annotations

import math

import torch

#: Axes of each leaf, unstacked, that its product contracts (the fan-in);
#: a leaf of a stacked group (``blocks``) has the layer axis before them.
#: A configuration file adds its model's other leaves as ``fan_in_axes``.
FAN_IN_AXES = {
    "wq": (0,), "wk": (0,), "wv": (0,), "wo": (0, 1),
    "router": (0,), "we_gate": (1,), "we_up": (1,), "we_down": (1,),
    "ws_gate": (0,), "ws_up": (0,), "ws_down": (0,),
    "embed/w": (1,), "lm_head/w": (0,),
}
#: Elements one draw fills.
CHUNK = 1 << 30


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


def _set(tree, path, value):
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def make_params(schema, seed: int, device, dtype=torch.bfloat16,
                fan_in: dict = None) -> dict:
    """The parameter tree ``schema`` (nested dicts of specs with ``shape``
    and ``init``) drawn from ``seed`` on ``device``; ``fan_in`` adds
    leaves to ``FAN_IN_AXES``."""
    axes_of = dict(FAN_IN_AXES, **{k: tuple(v) for k, v in (fan_in or {}).items()})
    leaves = list(_leaves(schema))
    total = sum(math.prod(sp.shape) for _p, sp in leaves)
    flat = torch.empty(total, dtype=dtype, device=device)
    gen = torch.Generator(device=device).manual_seed(seed % 2**63)
    for i in range(0, total, CHUNK):
        flat[i:i + CHUNK].normal_(generator=gen)
    params: dict = {}
    off = 0
    for path, sp in leaves:
        n = math.prod(sp.shape)
        leaf = flat[off:off + n].view(sp.shape)
        off += n
        if sp.init == "ones":
            leaf.fill_(1)
        elif sp.init == "zeros":
            leaf.zero_()
        else:
            name = "/".join(path[-2:]) if path[0] in ("embed", "lm_head") else path[-1]
            lead = 1 if path[0] == "blocks" else 0
            fan = math.prod(sp.shape[lead + a] for a in axes_of[name])
            leaf.mul_(1.0 / math.sqrt(fan))
        _set(params, path, leaf)
    return params

