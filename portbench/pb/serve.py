"""The serving cells: a model served through the port's ``launch.serve``.

The timed path is the program's serving loop: ``launch.serve.serve`` (the
KV tier's lookup, ``serve.decode.prefill`` on a miss, ``serve_step`` for
every decode step, greedy tokens), one request at a time, with the
program's ``serve.kv_tier.KVTierManager`` placing the prefix caches.  The
benchmark makes the weights (``weights.py``) and the prompts (the mix's
generator, ``traffic/<generator>.py``) from the seed.  The layer layout
(an unstacked prefix, a repeating pattern, which layers are MoE and which
caches carry a sequence axis) is read from the port's config.

* Set-up: the weights; the generator's set-up prompts (the pool a shared
  tier reuses, or one request of the longest length), which warm every
  kernel the window uses.
* Window: requests in order until ``seconds`` have passed; the request
  running then completes and counts, so the window ends with it.
* Traced runs wrap the program's prefill, decode step, MoE layer and
  attention call (module attributes) in host spans; the device ops each
  span launched are read off the profiler.
* After the window: the peak memory is read, the tier and its caches are
  freed, and the reference recomputes a seeded sample of the window's
  requests (the longest among them) from the same weights.

What the reference is handed of each sampled request comes from the
program's public calls, wrapped on the module for every run: the experts
each ``models.layers.moe_route`` call chose (its ``expert``) and the
caches ``launch.serve.serve_step`` returns.  A program that stops calling
either through its module attribute leaves the run without a result (the
run raises, naming the call), not with a wrong one.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from .record import RunRecord
from .weights import make_params

#: Served tokens the reference recomputes in a run, at the least.
CHECK_TOKENS = 384
#: Cache leaves with a sequence axis, by their rank unstacked (the axis is
#: 1, or 2 under a stacked group's leading layer axis), as the port's
#: ``serve.decode`` lays them out.
SEQ_LEAVES = {"k": 4, "v": 4, "ckv": 3, "krope": 3}
#: The sizes of the configuration file that must equal the port's config,
#: each checked where the file has it (the first three always).
_REQUIRED = ("num_hidden_layers", "hidden_size", "vocab_size")
_CHECKED = {
    "num_hidden_layers": lambda c: c.n_layers,
    "hidden_size": lambda c: c.d_model,
    "num_attention_heads": lambda c: c.n_heads,
    "num_key_value_heads": lambda c: c.n_kv_heads,
    "head_dim": lambda c: c.resolved_head_dim,
    "moe_intermediate_size": lambda c: c.moe.d_ff_expert,
    "shared_expert_intermediate_size":
        lambda c: c.moe.n_shared * c.moe.d_ff_expert,
    "num_experts": lambda c: c.moe.n_routed,
    "num_experts_per_tok": lambda c: c.moe.top_k,
    "vocab_size": lambda c: c.vocab,
    "rope_theta": lambda c: c.rope_theta,
    "rms_norm_eps": lambda c: c.norm_eps,
    "capacity_factor": lambda c: c.moe.capacity_factor,
}


def port_config(m: dict):
    """The port's config of the configuration file ``m``, checked size by
    size.  ``port_overrides`` (tests only) changes fields of the port's
    config first."""
    from repro_torch.configs import get_config
    cfg = get_config(m["port_arch"])
    over = dict(m.get("port_overrides", {}))
    if "moe" in over:
        over["moe"] = dataclasses.replace(cfg.moe, **over["moe"])
    cfg = dataclasses.replace(cfg, **over)
    for key, get in _CHECKED.items():
        if key not in m and key not in _REQUIRED:
            continue
        try:
            got = get(cfg)
        except AttributeError:          # e.g. MoE sizes of a dense model
            got = None
        if got != m[key]:
            raise ValueError(f"the port's {cfg.name} has {key} {got}, "
                             f"the configuration file {m[key]}")
    if m["torch_dtype"] != cfg.param_dtype or cfg.act_dtype != cfg.param_dtype:
        raise ValueError("the port's dtypes differ from the configuration's")
    return cfg


class _Spans:
    """Traced runs: host spans around the program's calls (module
    attributes), restored on exit."""

    def __init__(self, rec: RunRecord):
        self.rec = rec
        self.saved = []

    def wrap(self, module, name: str, label, record=None, optional=False):
        if optional and not hasattr(module, name):
            return
        orig = getattr(module, name)
        spans = self.rec.spans
        clock = time.time_ns

        def wrapper(*args, **kwargs):
            lab = label(*args, **kwargs) if callable(label) else label
            t0 = clock()
            out = orig(*args, **kwargs)
            spans.append((t0, clock(), lab))
            if record is not None:
                record(lab, *args, **kwargs)
            return out

        self.saved.append((module, name, orig))
        setattr(module, name, wrapper)

    def restore(self):
        for module, name, orig in reversed(self.saved):
            setattr(module, name, orig)
        self.saved = []


def _attn_call(rec):
    def record(lab, q, k, v, causal=True, q_offset=0, scale=None,
               window=None, kv_len=None):
        b, sq, hq, d = q.shape
        rec.calls.setdefault(lab, []).append(
            dict(b=b, hq=hq, hkv=k.shape[2], sq=sq, skv=k.shape[1], d=d,
                 causal=bool(causal), q_offset=int(q_offset),
                 window=window, kv_len=kv_len))
    return record


def run(m: dict, mix: dict, traffic, seed: int, seconds: float, trace: bool,
        device: str, timing: dict) -> RunRecord:
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import layers as L
    from repro_torch.models.transformer import model_schema
    from repro_torch.serve.kv_tier import KVTierManager

    rec = RunRecord()
    dev = torch.device(device)
    cfg = port_config(m)
    params = make_params(model_schema(cfg), seed, dev,
                         fan_in=m.get("fan_in_axes"))
    stream = traffic.stream(mix, cfg.vocab, seed)
    gen = stream.gen
    shared = mix["tier"] == "shared"
    torch.set_grad_enabled(False)

    def tier():
        return KVTierManager(device=dev)

    routes = _Routes(L, launch_serve, cfg)
    kv = tier()
    for doc in stream.setup_prompts():
        routes.serve(launch_serve, cfg, params, doc, gen,
                     kv if shared else tier(), dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    spans = _Spans(rec)
    prof = None
    if trace:
        from .trace import start_profiler
        spans.wrap(launch_serve, "prefill", "serve.prefill")
        spans.wrap(launch_serve, "serve_step", "serve.step")
        # Only names the breakdown's idle gaps: a private helper, which a
        # later program may drop.
        spans.wrap(launch_serve, "_clone", "serve.clone", optional=True)
        spans.wrap(L, "apply_moe", lambda cfg_, p, x: (
            "serve.moe_decode" if x.shape[1] == 1 else "serve.moe_prefill"))
        spans.wrap(L, "flash_attention_bshd", lambda q, *a, **k: (
            "serve.attn_decode" if q.shape[1] == 1 else "serve.attn_prefill"),
            record=_attn_call(rec))
        prof = start_profiler(cpu=True)
    stats0 = _tier_counts(kv)
    wall0 = time.time_ns()
    t0 = time.perf_counter()
    timing["window_start"] = t0
    served = []
    deadline = t0 + seconds
    i = 0
    try:
        while time.perf_counter() < deadline:
            prompt = stream.request(i)
            use = kv if shared else tier()
            out = routes.serve(launch_serve, cfg, params, prompt, gen, use, dev)
            served.append((prompt, out))
            i += 1
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        wall1 = time.time_ns()
        if prof is not None:
            prof.stop()
    finally:
        spans.restore()
        routes.restore()
    window_s = t1 - t0
    if dev.type == "cuda":
        rec.memory_peak_bytes = torch.cuda.max_memory_allocated()
    stats1 = _tier_counts(kv)

    rec.config = m
    rec.attempted = len(served)
    rec.failed = 0
    hits = [o["hit"][0] for _p, o in served]
    b = stream.batch
    tokens = sum(b * gen for _ in served)
    decode_s = sum(o["decode_s"][0] for _p, o in served)
    decode_steps = len(served) * (gen - 1)
    rec.e2e["serve_tokens_per_s"] = tokens / window_s
    rec.e2e["serve_tpot_ms"] = 1e3 * decode_s / decode_steps
    rec.counters.update(
        requests=len(served), hits=int(sum(hits)), tokens=tokens,
        decode_steps=decode_steps,
        tier_lookups=stats1["lookups"] - stats0["lookups"],
        tier_hits=stats1["hits"] - stats0["hits"], batch=b, gen_tokens=gen,
        prefill_lengths=[int(p.shape[1]) for (p, o) in served
                         if not o["hit"][0]],
        # The decode steps timed in decode_s write positions L .. L + gen - 2.
        served_lengths=[int(p.shape[1]) for p, _o in served])
    prefill_s = [o["prefill_s"][0] for _p, o in served if not o["hit"][0]]
    rec.counters["prefill_s"] = float(sum(prefill_s))
    rec.counters["decode_s"] = float(decode_s)
    rec.counters["serve_steps"] = sum(o["decode_steps"][0] for _p, o in served)
    if trace:
        from .trace import reduce_profile
        rec.trace = reduce_profile(prof, wall0, wall1, rec.spans)
    # The reference's sample: seeded, with the longest prompt in it.
    rng = np.random.default_rng([seed % 2**64, 0x5e12e])
    n_sample = min(-(-CHECK_TOKENS // (b * gen)), len(served))
    longest = max(range(len(served)), key=lambda j: served[j][0].shape[1])
    rest = [j for j in range(len(served)) if j != longest]
    pick = [longest] + sorted(rng.choice(rest, size=n_sample - 1,
                                         replace=False).tolist()) if rest else [longest]
    rec.outputs = {
        "params": params,
        "samples": [dict(prompt=served[j][0], tokens=served[j][1]["tokens"][0],
                         hit=bool(served[j][1]["hit"][0]),
                         routes=routes.of(served[j][0], served[j][1]),
                         kv=served[j][1]["kv"])
                    for j in pick],
    }
    del kv, served
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return rec


class _Routes:
    """Records what the reference needs of each request: the experts every
    MoE call of the program chose (``models.layers.moe_route``'s
    ``expert``, a device tensor kept as it is: no copy, no
    synchronisation), so that the reference can follow them, and the rows
    the request's decode steps left in every cache with a sequence axis
    (one copy of each at the request's end).  Each document's prefill
    routes are kept with the document."""

    def __init__(self, L, launch_serve, cfg):
        self.L, self.orig = L, L.moe_route
        self.launch_serve, self.orig_step = launch_serve, launch_serve.serve_step
        self.cfg = cfg
        #: MoE layers a forward calls, in the order it calls them.
        self.n_moe = (sum(s.mlp == "moe" for s in cfg.prefix)
                      + cfg.pattern_repeats()
                      * sum(s.mlp == "moe" for s in cfg.pattern))
        self.log = []
        self.prefill = {}
        self.caches = None

        def moe_route(cfg_, p, x):
            route = self.orig(cfg_, p, x)
            self.log.append(route.expert)
            return route

        def serve_step(*args, **kwargs):
            logits, caches = self.orig_step(*args, **kwargs)
            self.caches = caches
            return logits, caches
        L.moe_route = moe_route
        launch_serve.serve_step = serve_step

    def serve(self, launch_serve, cfg, params, prompt, gen, kv, dev):
        start = len(self.log)
        self.caches = None
        out = launch_serve.serve(cfg, params, [prompt], gen, kv, dev)
        calls = self.log[start:]
        del self.log[start:]
        # A request runs gen forwards: its prefill (or a hit's decode of
        # the prompt's last token again), then gen - 1 decode steps.
        if len(calls) != self.n_moe * gen or (gen > 1 and self.caches is None):
            raise RuntimeError(
                "the benchmark reads every models.layers.moe_route call and "
                "the caches launch.serve.serve_step returns; this request made "
                f"{len(calls)} routing calls (expected {self.n_moe * gen}) and "
                f"{'no' if self.caches is None else 'its'} decode caches")
        out["routes"] = calls
        if not out["hit"][0]:
            self.prefill[id(prompt)] = calls[:self.n_moe]
        out["kv"] = self._decoded_rows(prompt.shape[1], gen)
        self.caches = None
        return out

    def _decoded_rows(self, length: int, gen: int) -> dict:
        """The rows decode wrote, positions L - 1 .. L + gen - 2 (a miss's
        L - 1 is its prefill's), of every cache leaf with a sequence axis
        (K / V, MLA's latents; a window's ring buffer and a recurrent
        state have none): ``{group: {layer: {leaf: [..., B, gen, ...]}}}``
        with the stacked groups' layer axis first."""
        rows = {}
        for group, layers in self.caches.items():
            for name, leaves in layers.items():
                idx = int(name.replace("layer", "").replace("pos", ""))
                spec = (self.cfg.prefix if group == "prefix"
                        else self.cfg.pattern)[idx]
                for key, x in leaves.items():
                    if key not in SEQ_LEAVES or spec.window:
                        continue
                    ax = 1 + (x.dim() - SEQ_LEAVES[key])
                    rows.setdefault(group, {}).setdefault(name, {})[key] = \
                        x.narrow(ax, length - 1, gen).clone()
        return rows

    def of(self, prompt, out) -> list:
        """Per MoE layer, in the order a forward calls them, the experts
        [B, T, k] the run chose at every position of the prompt and the
        served tokens but the last."""
        b, length = prompt.shape
        calls, n = out["routes"], self.n_moe
        pre = self.prefill[id(prompt)]
        # A miss's first calls are its prefill, a hit's the decode of the
        # prompt's last token again; one call a layer for each step after.
        steps = (len(calls) - n) // n
        per_layer = []
        for layer in range(n):
            parts = [pre[layer].view(b, length, -1)]
            if out["hit"][0]:
                parts[0] = parts[0].clone()
                parts[0][:, -1:] = calls[layer].view(b, 1, -1)
            parts += [calls[n + s * n + layer].view(b, 1, -1)
                      for s in range(steps)]
            per_layer.append(torch.cat(parts, dim=1))
        return per_layer

    def restore(self):
        self.L.moe_route = self.orig
        self.launch_serve.serve_step = self.orig_step


def _tier_counts(kv) -> dict:
    s = kv.stats
    hits = sum(s["hits"].values())
    return {"hits": hits, "lookups": hits + s["misses"]}
