"""The plain reference of the ``deepseek-v2-lite-16b`` cells.

A float32 forward of the model as the configuration file states it and
as the port computes it (its departures from the published model are
listed in the file), in plain PyTorch with TF32 off, layer by layer from
the benchmark's own weights.  Multi-head latent attention in its
published, non-absorbed form: the latent ``c_kv = RMSNorm(x w_dkv[:R])``,
per-head keys ``K = [c_kv w_uk ; rope(x w_dkv[R:])]`` (the rope key shared
by every head) and values ``V = c_kv w_uv``, queries ``[x wq]`` with their
rope part rotated, causal softmax at the scale ``(nope + rope) ** -0.5``
times YaRN's ``mscale(factor, mscale_all_dim) ** 2``, computed in blocks of
query rows; rope is YaRN (Hugging Face's ``DeepseekV2YarnRotaryEmbedding``)
on the two halves of the rope columns.  Then the dense SwiGLU first layer,
and in every later layer the top-k router over softmax probabilities with
the gates renormalised, group-local capacity, the routed experts a token
keeps and the shared experts; the final norm and the head.  It imports
nothing of the port.

Prefill and decode route differently in the program, and the reference
follows it: a prompt of length L is one routing group (capacity
``max(int(capacity_factor * k * L / E), min(8, L * k))`` slots per expert,
pairs ranked token-major), and every decoded token is routed alone (never
dropped).  On a hit the program decodes the prompt's last token again, so
there position L - 1 is routed alone too.

What is compared: for a seeded sample of the window's requests (the
longest among them), the reference runs once over each prompt with its
served tokens, taking at every MoE layer the experts the run chose (the
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
    the widest error of the latent rows the run's decode left in its
    cache (``ckv`` and the rotated ``krope``, positions L - 1 onwards, the
    dense first layer's in ``kv["prefix"]["layer0"]`` and the others' in
    the port's stacked ``kv["blocks"]["pos0"]``) against the reference's,
    over the largest magnitude of the reference's rows: the decode step's
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
ROW_CHUNK = 256


def _fp8(x: torch.Tensor, dim) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale per slice along
    ``dim`` (the control's precision)."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    scale = amax / 448.0
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def _mscale(factor: float, mscale: float) -> float:
    return 0.1 * mscale * math.log(factor) + 1.0 if factor > 1 else 1.0


def yarn(m: dict, device):
    """(inverse frequencies [rope / 2], cos / sin scale, softmax factor)
    of the configuration's rope, as ``DeepseekV2YarnRotaryEmbedding`` and
    ``DeepseekV2Attention`` form them (plain rope without
    ``rope_scaling``)."""
    dim, base = m["qk_rope_head_dim"], float(m["rope_theta"])
    pos = torch.arange(0, dim, 2, dtype=torch.float32) / dim
    extra = 1.0 / base ** pos
    rs = m.get("rope_scaling")
    if not rs:
        return extra.to(device), 1.0, 1.0
    factor, orig = float(rs["factor"]), rs["original_max_position_embeddings"]

    def corr(rot):
        return dim * math.log(orig / (rot * 2 * math.pi)) / (2 * math.log(base))

    low = max(math.floor(corr(rs["beta_fast"])), 0)
    high = min(math.ceil(corr(rs["beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float32) - low)
            / (high - low)).clamp(0, 1)
    inter = 1.0 / (factor * base ** pos)
    inv = inter * ramp + extra * (1 - ramp)
    cs = _mscale(factor, rs["mscale"]) / _mscale(factor, rs["mscale_all_dim"])
    soft = _mscale(factor, rs["mscale_all_dim"]) ** 2 if rs["mscale_all_dim"] else 1.0
    return inv.to(device), cs, soft


class Reference:
    """The model's forward in float32.  ``fp8`` rounds every weight (per
    output column) and every activation entering a weight product (per
    row) to float8 e4m3: the control."""

    def __init__(self, params: dict, m: dict, fp8: bool = False):
        self.p, self.m, self.fp8 = params, m, fp8
        #: The widest router-logit margin by which a followed route's
        #: chosen expert lies below the k-th best (see ``moe``).
        self.margin = 0.0
        #: The routes the last ``logits`` call chose, one [B, T, k] a MoE
        #: layer.
        self.routes = []
        #: Each layer's latent rows (c_kv, rotated k_rope) at the positions
        #: ``logits`` was asked for: [B, len(want), R] and [.., rope].
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
        """x [B, T, H, rope] rotated as two halves at positions ``pos``."""
        d = x.shape[-1]
        ang = pos.float()[:, None] * self.inv[None, :]
        cos = (ang.cos() * self.cs)[None, :, None]
        sin = (ang.sin() * self.cs)[None, :, None]
        x1, x2 = x[..., : d // 2], x[..., d // 2:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)

    def attention(self, lp, h, pos):
        m = self.m
        nope, rope, r = (m["qk_nope_head_dim"], m["qk_rope_head_dim"],
                         m["kv_lora_rank"])
        ha = self.a(h)
        q = torch.einsum("btd,dhk->bthk", ha, self.w(lp["wq"], 0))
        dkv = ha @ self.w(lp["w_dkv"], 0)
        c_kv = self.rms(dkv[..., :r], lp["kv_norm"])
        k_rope = self.rope(dkv[..., None, r:], pos)             # [B, T, 1, rope]
        q_rope = self.rope(q[..., nope:], pos)
        self.kv.append((c_kv[:, self.want], k_rope[:, self.want, 0]))
        ca = self.a(c_kv)
        k_nope = torch.einsum("btr,rhk->bthk", ca, self.w(lp["w_uk"], 0))
        v = torch.einsum("btr,rhv->bthv", ca, self.w(lp["w_uv"], 0))
        b, t, heads, _ = q.shape
        qf = torch.cat([q[..., :nope], q_rope], dim=-1)
        k = torch.cat([k_nope, k_rope.expand(b, t, heads, rope)], dim=-1)
        scale = (nope + rope) ** -0.5 * self.soft
        out = torch.empty(b, t, heads, v.shape[-1], device=h.device)
        for r0 in range(0, t, ROW_CHUNK):
            r1 = min(t, r0 + ROW_CHUNK)
            s = torch.einsum("bqhd,bkhd->bhqk", qf[:, r0:r1], k[:, :r1]) * scale
            mask = (torch.arange(r1, device=h.device)[None, :]
                    <= torch.arange(r0, r1, device=h.device)[:, None])
            s = s.masked_fill(~mask, float("-inf"))
            out[:, r0:r1] = torch.einsum("bhqk,bkhv->bqhv", s.softmax(-1),
                                         v[:, :r1])
            del s
        return torch.einsum("bthv,hvd->btd", self.a(out), self.w(lp["wo"], (0, 1)))

    def dense(self, lp, h):
        ha = self.a(h)
        g = ha @ self.w(lp["w_gate"], 0)
        u = ha @ self.w(lp["w_up"], 0)
        return self.a(F.silu(g) * u) @ self.w(lp["w_down"], 0)

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
        e_n, k_n = m["n_routed_experts"], m["num_experts_per_tok"]
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
            del onehot, rank
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
        return out + self.dense({"w_gate": lp["ws_gate"], "w_up": lp["ws_up"],
                                 "w_down": lp["ws_down"]}, h)

    def layers(self):
        """(attention, norms, MLP weights, is_moe) of every layer in
        order: the dense prefix, then the stacked MoE layers."""
        p = self.p
        n_dense = self.m["first_k_dense_replace"]
        for i in range(n_dense):
            lp = p["prefix"][f"layer{i}"]
            yield lp["mixer"], lp["norm1"]["scale"], lp["norm2"]["scale"], lp["mlp"], False
        blocks = p["blocks"]["pos0"]
        for layer in range(self.m["num_hidden_layers"] - n_dense):
            yield ({k: v[layer] for k, v in blocks["mixer"].items()},
                   blocks["norm1"]["scale"][layer], blocks["norm2"]["scale"][layer],
                   {k: v[layer] for k, v in blocks["mlp"].items()}, True)

    @torch.no_grad()
    def logits(self, seq: torch.Tensor, group: int, free_from: int,
               want: torch.Tensor, routes=None) -> torch.Tensor:
        """Logits ``[B, len(want), V]`` of token ids ``seq`` [B, T] at
        positions ``want``; positions ``< group`` are one routing group,
        positions ``>= free_from`` are routed alone; ``routes`` (one
        [B, T, k] a MoE layer) are followed as ``moe`` says."""
        p, m = self.p, self.m
        self.routes, self.kv, self.want = [], [], want
        self.inv, self.cs, self.soft = yarn(m, seq.device)
        x = p["embed"]["w"][seq].float() * math.sqrt(m["hidden_size"])
        pos = torch.arange(seq.shape[1], device=seq.device)
        n_moe = 0
        for mixer, norm1, norm2, mlp, is_moe in self.layers():
            x = x + self.attention(mixer, self.rms(x, norm1), pos)
            h = self.rms(x, norm2)
            if is_moe:
                x = x + self.moe(mlp, h, group, free_from,
                                 None if routes is None else routes[n_moe])
                n_moe += 1
            else:
                x = x + self.dense(mlp, h)
        x = self.rms(x[:, want], p["final_norm"]["scale"])
        return self.a(x) @ self.w(p["lm_head"]["w"], 0)


def _inputs(sample: dict, device):
    prompt, tokens = sample["prompt"], sample["tokens"]
    length, gen = prompt.shape[1], tokens.shape[1]
    seq = torch.cat([prompt, tokens[:, :-1]], dim=1).to(device)
    want = torch.arange(length - 1, length + gen - 1, device=device)
    free = length - 1 if sample["hit"] else length
    return seq, length, free, want


def _rows(ref: Reference, n_dense: int) -> list:
    """(group, layer, leaf, the reference's rows, the layer's index in a
    stacked group or None) of every latent row set."""
    out = []
    for i, (c, k) in enumerate(ref.kv):
        if i < n_dense:
            out += [("prefix", f"layer{i}", "ckv", c, None),
                    ("prefix", f"layer{i}", "krope", k, None)]
        else:
            out += [("blocks", "pos0", "ckv", c, i - n_dense),
                    ("blocks", "pos0", "krope", k, i - n_dense)]
    return out


def kv_error(ref: Reference, kv: dict, m: dict) -> float:
    """The widest error of the latent rows a run left in its cache against
    the reference's at the same positions, each layer's and each of
    ``ckv``, ``krope`` over the largest magnitude of the reference's rows
    there."""
    worst = 0.0
    for group, name, leaf, want, layer in _rows(ref, m["first_k_dense_replace"]):
        got = kv[group][name][leaf]
        got = (got if layer is None else got[layer]).to(want.device).float()
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
    token put first at each position (``first``), its routes and its
    latent rows; ``compare`` then judges them as it judges a run."""
    _no_tf32()
    params = out["params"]
    device = params["embed"]["w"].device
    low = Reference(params, m, fp8=True)
    n_dense = m["first_k_dense_replace"]
    samples = []
    for s in out["samples"]:
        seq, length, free, want = _inputs(s, device)
        first = low.logits(seq, length, free, want).argmax(-1)
        kv = {"prefix": {f"layer{i}": {"ckv": c, "krope": k}
                         for i, (c, k) in enumerate(low.kv[:n_dense])},
              "blocks": {"pos0": {
                  "ckv": torch.stack([c for c, _k in low.kv[n_dense:]]),
                  "krope": torch.stack([k for _c, k in low.kv[n_dense:]])}}}
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
        kv = max(kv, kv_error(ref, s["kv"], m))
    return [("served_logit_gap_max", worst, LIMITS["served_logit_gap_max"]),
            ("route_margin_max", ref.margin, LIMITS["route_margin_max"]),
            ("kv_rel_err_max", kv, LIMITS["kv_rel_err_max"])]
