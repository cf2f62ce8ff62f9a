"""The serving cells of a model with multi-head latent attention: the
serving system of ``serve.py``, the configuration's MLA widths and rope
scaling checked against the port's, and in traced runs the device time of
the program's own MLA spans.

A configuration file names this module (``"system": "serve_mla"``) where
its model attends in latent space (DeepSeek-V2's MLA).  Beside what
``serve.port_config`` checks, the port's config must hold the file's
latent widths, experts and dense first layers, and the file's
``rope_scaling`` (YaRN) exactly: a program without them cannot run the
configuration, and the run raises before its set-up.

Traced runs add to the reduced trace (``run.trace``):

``program``
    for each program span of :data:`DEVICE_SPANS` (``repro_torch.tracing``;
    ``mla.kernel``: the attention call inside ``models.layers.apply_mla``),
    the device seconds and count of the operations launched inside such
    spans that lie in the window's decode steps (``serve.decode_step``).
    Empty for a program without the spans.
``mla_calls``
    the shapes of every call of ``repro_torch.kernels.mla_decode.mla_decode``
    made in the window (``b``, ``heads``, ``kv_len``, ``latent``, ``rope``,
    ``item``), read from its arguments; empty for a program without it.

and to the counters ``mla_decode_launches``: the kernels' launches in the
window (two a call on the card, none on the CPU), where the program counts
them.  Everything else is ``serve.run``'s, unchanged, except that a run
leaves autograd as it found it (``serve.run`` turns it off and leaves it
so in its caller's process).
"""

from __future__ import annotations

import bisect
import dataclasses

from . import serve, trace as _trace

#: Program spans whose device time a traced run reads.
DEVICE_SPANS = ("mla.kernel",)
DECODE_STEP = "serve.decode_step"

#: Sizes of the configuration file that must equal the port's config.
_MLA_CHECKED = {
    "kv_lora_rank": lambda c: c.mla.kv_lora_rank,
    "q_lora_rank": lambda c: c.mla.q_lora_rank,
    "qk_nope_head_dim": lambda c: c.mla.qk_nope_dim,
    "qk_rope_head_dim": lambda c: c.mla.qk_rope_dim,
    "v_head_dim": lambda c: c.mla.v_head_dim,
    "n_routed_experts": lambda c: c.moe.n_routed,
    "n_shared_experts": lambda c: c.moe.n_shared,
    "intermediate_size": lambda c: c.d_ff,
    "first_k_dense_replace": lambda c: sum(s.mlp != "moe" for s in c.prefix),
}


def _yarn_of(cfg):
    y = getattr(cfg, "yarn", None)
    if y is None:
        return None
    return (y.factor, y.original_max_position, y.beta_fast, y.beta_slow,
            y.mscale, y.mscale_all_dim)


def port_config(m: dict):
    """``serve.port_config``, its ``port_overrides`` (tests only) also
    taking ``mla`` (fields of the latent widths), then the latent widths,
    experts, dense layers and rope scaling checked."""
    over = dict(m.get("port_overrides", {}))
    mla = over.pop("mla", None)
    cfg = _serve_port_config(dict(m, port_overrides=over))
    if mla:
        cfg = dataclasses.replace(cfg, mla=dataclasses.replace(cfg.mla, **mla))
    if cfg.mla is None:
        raise ValueError(f"the port's {cfg.name} has no latent attention")
    for key, get in _MLA_CHECKED.items():
        if key in m and get(cfg) != m[key]:
            raise ValueError(f"the port's {cfg.name} has {key} {get(cfg)}, "
                             f"the configuration file {m[key]}")
    rs = m.get("rope_scaling")
    want = None if not rs else (
        float(rs["factor"]), int(rs["original_max_position_embeddings"]),
        float(rs["beta_fast"]), float(rs["beta_slow"]), float(rs["mscale"]),
        float(rs["mscale_all_dim"]))
    if rs and rs.get("type") != "yarn":
        raise ValueError(f"rope scaling {rs.get('type')!r} is not YaRN")
    if _yarn_of(cfg) != want:
        raise ValueError(f"the port's {cfg.name} has rope scaling "
                         f"{_yarn_of(cfg)}, the configuration file {want} "
                         "(factor, original positions, beta_fast, beta_slow, "
                         "mscale, mscale_all_dim)")
    return cfg


_serve_port_config = serve.port_config


class _Calls:
    """Records the shapes of the kernel entry's calls while armed, and the
    kernels' launches (``mla_decode.launches``) between arming and
    disarming."""

    def __init__(self):
        self.calls, self.armed, self.saved = [], False, None
        self.launches = None

    def arm(self, on: bool):
        self.armed = on
        if self.saved:
            mod = self.saved[0]
            self.launches = (mod.launches if on
                             else mod.launches - self.launches)

    def wrap(self):
        try:
            from repro_torch.kernels import mla_decode as mod
        except ImportError:                 # a program without the kernels
            return
        orig = getattr(mod, "mla_decode", None)
        if orig is None:
            return

        def call(q_lat, q_rope, ckv, krope, kv_len, scale):
            if self.armed:
                b, _s, heads, latent = q_lat.shape
                self.calls.append(dict(b=b, heads=heads, kv_len=int(kv_len),
                                       latent=latent, rope=q_rope.shape[-1],
                                       item=ckv.element_size()))
            return orig(q_lat, q_rope, ckv, krope, kv_len, scale)

        self.saved = (mod, orig)
        mod.mla_decode = call

    def restore(self):
        if self.saved:
            mod, orig = self.saved
            mod.mla_decode = orig
            self.saved = None


def program_device(prof, wall_start: int, wall_end: int,
                   names=DEVICE_SPANS) -> dict:
    """Device seconds and count of the operations launched inside the
    program's spans ``names`` that lie in the window's decode steps, by
    name; ``{}`` without the program's tracer, or if it dropped a span in
    the window."""
    try:
        from repro_torch import tracing
    except ImportError:
        return {}
    if tracing.dropped and tracing.dropped_ns >= wall_start:
        return {}
    buf = tracing.spans()
    intervals = {n: [] for n in names}
    for name, a, b, parent in buf:
        if name not in intervals or not wall_start <= a <= wall_end:
            continue
        up = parent
        while up >= 0 and buf[up][0] != DECODE_STEP:
            up = buf[up][3]
        if up >= 0:
            intervals[name].append((a, b))
    try:
        events = prof.profiler.kineto_results.events()
    except AttributeError:
        events = prof.events()
    device, launches = [], {}
    for e in events:
        if str(e.device_type()).endswith("CUDA"):
            device.append((e.duration_ns(), e.correlation_id()))
        elif e.name() in _trace._LAUNCHES:
            launches[e.correlation_id()] = e.start_ns()
    out = {}
    for name, iv in intervals.items():
        if not iv:
            continue
        iv.sort()
        starts = [a for a, _b in iv]
        secs, n = 0.0, 0
        for dur, corr in device:
            t = launches.get(corr)
            if t is None:
                continue
            j = bisect.bisect_right(starts, t) - 1
            if j >= 0 and t <= iv[j][1]:
                secs += dur * 1e-9
                n += 1
        out[name] = {"device_s": secs, "ops": n, "spans": len(iv)}
    return out


def run(m: dict, mix: dict, traffic, seed: int, seconds: float, trace: bool,
        device: str, timing: dict):
    port_config(m)                          # before any set-up
    calls = _Calls()
    saved = [(serve, "port_config", serve.port_config)]
    serve.port_config = port_config
    if trace:
        start, reduce = _trace.start_profiler, _trace.reduce_profile

        def start_profiler(*a, **k):
            calls.arm(True)
            return start(*a, **k)

        def reduce_profile(prof, wall0, wall1, spans):
            calls.arm(False)
            out = reduce(prof, wall0, wall1, spans)
            out["program"] = program_device(prof, wall0, wall1)
            out["mla_calls"] = list(calls.calls)
            return out

        saved += [(_trace, "start_profiler", start),
                  (_trace, "reduce_profile", reduce)]
        _trace.start_profiler = start_profiler
        _trace.reduce_profile = reduce_profile
        calls.wrap()
    import torch
    grad = torch.is_grad_enabled()          # serve.run turns autograd off
    try:
        rec = serve.run(m, mix, traffic, seed, seconds, trace, device, timing)
        if calls.launches is not None and not calls.armed:
            rec.counters["mla_decode_launches"] = calls.launches
        return rec
    finally:
        torch.set_grad_enabled(grad)
        calls.restore()
        for mod, name, orig in saved:
            setattr(mod, name, orig)
