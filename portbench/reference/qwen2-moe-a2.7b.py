"""The plain reference of the ``qwen2-moe-a2.7b`` cells.

A float32 forward of the model as the configuration file states it and
as the port computes it (its departures from the published model are
listed in the file), in plain PyTorch with TF32 off, layer by layer from
the benchmark's own weights: RMSNorm, rotary attention (halves rotated),
causal softmax attention, the top-k router over softmax probabilities with
the gates renormalised, group-local capacity, the routed experts a token
keeps, the shared expert, the final norm and the head.  It imports nothing
of the port.

Prefill and decode route differently in the program, and the reference
follows it: a prompt of length L is one routing group (capacity
``max(int(capacity_factor * k * L / E), min(8, L * k))`` slots per expert,
pairs ranked token-major), and every decoded token is routed alone (never
dropped).  On a hit the program decodes the prompt's last token again, so
there position L - 1 is routed alone too.

What is compared: for a seeded sample of the window's requests (the
longest among them), the reference runs once over each prompt with its
served tokens, taking at every layer the experts the run chose (the
run's routes, recorded as it served):

``served_logit_gap_max``
    the widest gap by which a served token's logit lies below the
    reference's best logit at that position.  Greedy decoding serves the
    run's best token, so a sound run reads its bf16 rounding only.  (A
    sample may name the token put first at each position apart from the
    tokens served, ``first``: the control does, see ``control_outputs``.)
``route_margin_max``
    the widest margin by which an expert the run chose lies below the
    reference's k-th best router logit (0 where they choose alike).
``kv_rel_err_max``
    the widest error of the K / V rows the run's decode left in its cache
    (positions L - 1 onwards, every layer; ``kv["blocks"]["pos0"]``, the
    port's stacked layout of this model) against the reference's, over
    the largest magnitude of the reference's rows: the decode step's
    state, which the served tokens alone can barely show (attention
    spread over a long prompt hides a missing row).

The limits and the readings they were set from are in PERF.md.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

LIMITS = {"served_logit_gap_max": 0.3, "route_margin_max": 0.4,
          "kv_rel_err_max": 0.09}
ROW_CHUNK = 512


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale per slice along
    ``dim`` (the control's precision)."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    scale = amax / 448.0
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class Reference:
    """The model's forward in float32.  ``fp8`` rounds every weight (per
    output column) and every activation entering a weight product (per
    row) to float8 e4m3: the control."""

    def __init__(self, params: dict, m: dict, fp8: bool = False):
        self.p, self.m, self.fp8 = params, m, fp8
        #: The widest router-logit margin by which a followed route's
        #: chosen expert lies below the k-th best (see ``moe``).
        self.margin = 0.0
        #: The routes the last ``logits`` call chose, one [B, T, k] a layer.
        self.routes = []
        #: Each layer's K (rotated) and V at the positions ``logits`` was
        #: asked for: [B, len(want), H, D] each.
        self.kv = []

    def w(self, t: torch.Tensor, contract_dims) -> torch.Tensor:
        w = t.float()
        if self.fp8:
            w = _fp8(w, contract_dims)
        return w

    def a(self, x: torch.Tensor) -> torch.Tensor:
        return _fp8(x, -1) if self.fp8 else x

    def rms(self, x, scale):
        eps = self.m["rms_norm_eps"]
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale.float()

    def rope(self, x, pos):
        d = x.shape[-1]
        inv = 1.0 / self.m["rope_theta"] ** (
            torch.arange(0, d, 2, dtype=torch.float64, device=x.device) / d)
        ang = pos.double()[:, None] * inv[None, :]
        cos, sin = ang.cos().float()[None, :, None], ang.sin().float()[None, :, None]
        x1, x2 = x[..., : d // 2], x[..., d // 2:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)

    def attention(self, lp, h, pos):
        m = self.m
        hq, hkv = m["num_attention_heads"], m["num_key_value_heads"]
        ha = self.a(h)
        q = torch.einsum("btd,dhk->bthk", ha, self.w(lp["wq"], 0))
        k = torch.einsum("btd,dhk->bthk", ha, self.w(lp["wk"], 0))
        v = torch.einsum("btd,dhk->bthk", ha, self.w(lp["wv"], 0))
        q, k = self.rope(q, pos), self.rope(k, pos)
        self.kv.append((k[:, self.want], v[:, self.want]))
        if hkv != hq:
            k = k.repeat_interleave(hq // hkv, dim=2)
            v = v.repeat_interleave(hq // hkv, dim=2)
        t = h.shape[1]
        scale = q.shape[-1] ** -0.5
        out = torch.empty_like(q)
        for r0 in range(0, t, ROW_CHUNK):
            r1 = min(t, r0 + ROW_CHUNK)
            s = torch.einsum("bqhd,bkhd->bhqk", q[:, r0:r1], k[:, :r1]) * scale
            mask = (torch.arange(r1, device=h.device)[None, :]
                    <= torch.arange(r0, r1, device=h.device)[:, None])
            s = s.masked_fill(~mask, float("-inf"))
            out[:, r0:r1] = torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1),
                                         v[:, :r1])
        return torch.einsum("bthk,hkd->btd", self.a(out), self.w(lp["wo"], (0, 1)))

    def moe(self, lp, h, group: int, free_from: int, route=None):
        """The MoE layer.  With ``route`` (the experts [B, T, k] a run
        chose) the layer takes those experts, with gates from its own
        probabilities, and records in ``margin`` how far below its own
        k-th best router logit the worst chosen expert lies (0 where the
        choices agree): at a near-tie the run's bf16 hidden state may pick
        the other expert, and one such pick moves a token's whole layer
        output, so the reference follows the choice and judges it by its
        margin instead."""
        m = self.m
        e_n, k_n = m["num_experts"], m["num_experts_per_tok"]
        b, t, d = h.shape
        logits = h @ lp["router"].float()
        probs = logits.softmax(-1)
        if route is None:
            gates, idx = torch.topk(probs, k_n, dim=-1)
        else:
            idx = route.to(h.device).long()
            gates = probs.gather(-1, idx)
            kth = torch.topk(logits, k_n, dim=-1).values[..., -1]
            worst = logits.gather(-1, idx).min(-1).values
            self.margin = max(self.margin,
                              float((kth - worst).clamp_min(0).max()))
        self.routes.append(idx)
        gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
        keep = torch.ones_like(idx, dtype=torch.bool)
        if group:
            cap = max(int(m["capacity_factor"] * k_n * group / e_n),
                      min(8, group * k_n))
            onehot = F.one_hot(idx[:, :group].reshape(b, group * k_n), e_n)
            rank = ((onehot.cumsum(1) - onehot) * onehot).sum(-1)
            keep[:, :group] = (rank < cap).view(b, group, k_n)
        keep[:, free_from:] = True
        ha = self.a(h)
        out = torch.zeros_like(h)
        for e in range(e_n):
            bi, ti, ki = torch.nonzero((idx == e) & keep, as_tuple=True)
            if not len(bi):
                continue
            xe = ha[bi, ti]
            g = xe @ self.w(lp["we_gate"][e], 0)
            u = xe @ self.w(lp["we_up"][e], 0)
            y = self.a(F.silu(g) * u) @ self.w(lp["we_down"][e], 0)
            out.index_put_((bi, ti), y * gates[bi, ti, ki][:, None],
                           accumulate=True)
        g = ha @ self.w(lp["ws_gate"], 0)
        u = ha @ self.w(lp["ws_up"], 0)
        return out + self.a(F.silu(g) * u) @ self.w(lp["ws_down"], 0)

    @torch.no_grad()
    def logits(self, seq: torch.Tensor, group: int, free_from: int,
               want: torch.Tensor, routes=None) -> torch.Tensor:
        """Logits ``[B, len(want), V]`` of token ids ``seq`` [B, T] at
        positions ``want``; positions ``< group`` are one routing group,
        positions ``>= free_from`` are routed alone; ``routes`` (one
        [B, T, k] a layer) are followed as ``moe`` says."""
        p, m = self.p, self.m
        self.routes, self.kv, self.want = [], [], want
        x = p["embed"]["w"][seq].float() * math.sqrt(m["hidden_size"])
        pos = torch.arange(seq.shape[1], device=seq.device)
        blocks = p["blocks"]["pos0"]
        for layer in range(m["num_hidden_layers"]):
            lp = {k: v[layer] for k, v in blocks["mixer"].items()}
            x = x + self.attention(lp, self.rms(x, blocks["norm1"]["scale"][layer]), pos)
            lp = {k: v[layer] for k, v in blocks["mlp"].items()}
            x = x + self.moe(lp, self.rms(x, blocks["norm2"]["scale"][layer]),
                             group, free_from,
                             None if routes is None else routes[layer])
        x = self.rms(x[:, want], p["final_norm"]["scale"])
        return self.a(x) @ self.w(p["lm_head"]["w"], 0)


def _inputs(sample: dict, device):
    prompt, tokens = sample["prompt"], sample["tokens"]
    length, gen = prompt.shape[1], tokens.shape[1]
    seq = torch.cat([prompt, tokens[:, :-1]], dim=1).to(device)
    want = torch.arange(length - 1, length + gen - 1, device=device)
    free = length - 1 if sample["hit"] else length
    return seq, length, free, want


def kv_error(ref: Reference, kv: dict) -> float:
    """The widest error of the K / V rows a run left in its cache against
    the reference's at the same positions, each layer's and each of K, V
    over the largest magnitude of the reference's rows there."""
    worst = 0.0
    rows = kv["blocks"]["pos0"]
    for layer, (k, v) in enumerate(ref.kv):
        for name, want in (("k", k), ("v", v)):
            got = rows[name][layer].to(want.device).float()
            worst = max(worst, float((got - want).abs().max()
                                     / want.abs().max().clamp_min(1e-30)))
    return worst


def gaps(ref: Reference, sample: dict, device) -> torch.Tensor:
    """For each position a token was served at: the reference's best logit
    there less the reference's logit of the token put first (the served
    token itself, unless the sample names ``first``), the reference
    following the run's routes (``sample["routes"]``)."""
    seq, length, free, want = _inputs(sample, device)
    lg = ref.logits(seq, length, free, want, routes=sample["routes"])
    first = sample.get("first", sample["tokens"]).to(device)
    return lg.max(-1).values - lg.gather(-1, first[..., None])[..., 0]


def control_outputs(out: dict, m: dict) -> dict:
    """The control put in the program's place: what a run hands ``compare``
    (``out``), made again by this reference in float8 e4m3 (``fp8``) over
    the same prompts and served tokens, routing by itself.  Each sample
    keeps the run's prompt and served tokens, and takes the float8 model's
    token put first at each position (``first``), its routes and its K / V
    rows; ``compare`` then judges them as it judges a run."""
    _no_tf32()
    params = out["params"]
    device = params["embed"]["w"].device
    low = Reference(params, m, fp8=True)
    samples = []
    for s in out["samples"]:
        seq, length, free, want = _inputs(s, device)
        first = low.logits(seq, length, free, want).argmax(-1)
        kv = {"blocks": {"pos0": {"k": torch.stack([k for k, _v in low.kv]),
                                  "v": torch.stack([v for _k, v in low.kv])}}}
        samples.append(dict(s, first=first, routes=low.routes, kv=kv))
    return {"params": params, "samples": samples}


def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def compare(out: dict, m: dict, seed: int) -> list:
    _no_tf32()
    params = out["params"]
    device = params["embed"]["w"].device
    ref = Reference(params, m)
    worst = kv = 0.0
    for s in out["samples"]:
        worst = max(worst, float(gaps(ref, s, device).max()))
        kv = max(kv, kv_error(ref, s["kv"]))
    return [("served_logit_gap_max", worst, LIMITS["served_logit_gap_max"]),
            ("route_margin_max", ref.margin, LIMITS["route_margin_max"]),
            ("kv_rel_err_max", kv, LIMITS["kv_rel_err_max"])]
