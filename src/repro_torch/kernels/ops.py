"""Public wrappers around the port's kernels.

Each op accepts natural shapes (numpy arrays or tensors), places them on the
requested device, runs the kernel there -- its plain version when the device
is the CPU.  The TTL decision (the TTL = 0 column and the tie rule) is the
TTL-scan kernel's own epilogue; the GQA fold and layout of attention stay in
plain PyTorch, as in the JAX reference.
"""

from __future__ import annotations

import torch

from . import ref
from . import ttl_scan as _ttl_kernel
from .flash_attention import flash_attention_bshd
from .ttl_scan import ttl_decision

F32 = torch.float32
F64 = torch.float64
CPU = torch.device("cpu")

#: The least compute capability the kernels are built for (sm_90a).
MIN_CAPABILITY = (9, 0)


def resolve_device(device) -> torch.device:
    """``device`` as a :class:`torch.device`, checked: a CUDA device must be
    present and be Hopper or newer, or this raises -- the port never falls
    back to the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but no CUDA device is available; "
            "pass device='cpu' to run on the CPU")
    cap = torch.cuda.get_device_capability(dev)
    if cap < MIN_CAPABILITY:
        raise RuntimeError(
            f"device {dev} has compute capability {cap}; the kernels are "
            f"built for sm_90a and need at least {MIN_CAPABILITY}")
    return dev


def _placement(x, device) -> torch.device:
    """Where an op runs: ``device`` if given; else where the tensor ``x``
    lies; else (numpy arrays, lists) the card, as every entry point."""
    if device is not None:
        return resolve_device(device)
    if isinstance(x, torch.Tensor):
        return x.device
    return resolve_device("cuda")


# ---------------------------------------------------------------------------
# TTL expected-cost scan
# ---------------------------------------------------------------------------

def ttl_scan(
    hist, time_w, last, edges, s_price, n_price, first_remote,
    device=None,
):
    """Batched TTL selection over E directed edges.

    Returns ``(best_ttl [E], best_cost [E], cost_surface [E, C+1])`` as
    float32 tensors on ``device`` (default: where ``hist`` lies, else the
    card), where candidate 0 is TTL=0 (evict immediately) and candidate j+1
    is TTL=edges[j]; the best candidate is the raw argmin, as in the JAX
    package.  The surface and its TTL = 0 column are the kernel's on a CUDA
    device and their plain version on the CPU.
    """
    device = _placement(hist, device)

    def put(x):
        return torch.as_tensor(x, dtype=F32, device=device).contiguous()

    hist, time_w, last, edges = (put(x) for x in (hist, time_w, last, edges))
    s_price, n_price, first_remote = (put(x) for x in
                                      (s_price, n_price, first_remote))
    _idx, _best, zero, surface = ttl_decision(
        hist, time_w, last, edges, s_price, n_price, first_remote,
        surface=True)
    full = torch.cat([zero[:, None], surface], dim=1)
    idx = torch.argmin(full, dim=1)
    ttls = torch.cat([edges.new_zeros(1), edges])
    return ttls[idx], full.gather(1, idx[:, None])[:, 0], full


class _RefreshBuffers:
    """What a refresh reuses on one card, so that it makes one copy in, one
    launch and one copy out: pinned float32 host staging for the inputs and
    its device twin, the device outputs and their pinned host twin (each
    grown on demand), and the last cell layout seen -- its edges in float32
    on the card and its float64 candidate grid ``[0, edges...]`` on the host.
    """

    def __init__(self, device: torch.device):
        self.device = device
        self.host_in = self.dev_in = self.dev_out = self.host_out = None
        self.layout = self.edges = self.candidates = None

    def inputs(self, n: int):
        if self.host_in is None or self.host_in.numel() < n:
            size = max(n, 2 * (0 if self.host_in is None else self.host_in.numel()))
            self.host_in = torch.empty(size, dtype=F32, pin_memory=True)
            self.dev_in = torch.empty(size, dtype=F32, device=self.device)
        return self.host_in[:n], self.dev_in[:n]

    def outputs(self, n: int):
        if self.host_out is None or self.host_out.numel() < n:
            size = max(n, 2 * (0 if self.host_out is None else self.host_out.numel()))
            self.host_out = torch.empty(size, dtype=torch.int32, pin_memory=True)
            self.dev_out = torch.empty(size, dtype=torch.int32, device=self.device)
        return self.host_out[:n], self.dev_out[:n]

    def use_layout(self, edges: torch.Tensor) -> None:
        """Upload ``edges`` (float64, CPU) unless they are the layout on the
        card already."""
        if edges is self.layout:
            return
        if (self.layout is None or self.layout.shape != edges.shape
                or not torch.equal(self.layout, edges)):
            self.edges = edges.to(device=self.device, dtype=F32)
            self.candidates = torch.cat([edges.new_zeros(1), edges.to(F64)])
        self.layout = edges


_BUFFERS: dict = {}


def _ttl_decide(histograms, s_price, n_price, device, surface=False):
    """One batched TTL decision: E edge rows, each priced against its
    histogram.

    ``histograms`` -- one AccessHistogram that every row shares, or a list
                      of E that share one cell layout (a list of one object
                      repeated is packed as one row);
    ``s_price``, ``n_price`` -- float64 ``[E]`` CPU tensors ($ / byte-second
                      at the target, $ / byte on the edge);
    ``device``     -- the card, or the CPU for the plain version.

    Returns ``(ttls [E], costs [E], surface)`` on the CPU: TTLs from the
    float64 candidate grid ``[0, edges...]`` by the canonical-argmin index,
    costs as the float64 of the float32 cost there, and the float32
    ``[E, C+1]`` surface (column 0 is TTL = 0) when ``surface`` is true,
    else None.  On a card: the histograms and prices are packed into one
    pinned float32 staging tensor, copied to the card once (the edges stay
    there per cell layout), decided by one launch, and the index and cost
    (and the surface, if asked) copied back once, then one synchronise.
    """
    if isinstance(histograms, (list, tuple)):
        rows = list(histograms)
        if all(h is rows[0] for h in rows):
            rows = rows[:1]
    else:
        rows = [histograms]
    for h in rows[1:]:
        rows[0]._check_layout(h)
    edges = rows[0].edges
    e_dim, c_dim, r_dim = s_price.shape[0], edges.shape[0], len(rows)
    firsts = (torch.full((e_dim,), rows[0].first_read_remote_bytes, dtype=F64)
              if r_dim == 1 else
              torch.tensor([h.first_read_remote_bytes for h in rows], dtype=F64))

    if device.type == "cpu":
        def stack(name):
            return torch.stack([getattr(h, name) for h in rows]).to(F32)

        idx, best, zero, surf = ref.ttl_decision_ref(
            stack("hist"), stack("time_weight"), stack("last"),
            edges.to(F32), s_price.to(F32), n_price.to(F32), firsts.to(F32))
        candidates = torch.cat([edges.new_zeros(1), edges.to(F64)])
        full = torch.cat([zero[:, None], surf], dim=1) if surface else None
        return candidates[idx], best.to(F64), full

    buf = _BUFFERS.get(device)
    if buf is None:
        buf = _BUFFERS[device] = _RefreshBuffers(device)
    buf.use_layout(edges)
    rc = r_dim * c_dim
    host_in, dev_in = buf.inputs(3 * rc + 3 * e_dim)
    for k, name in enumerate(("hist", "time_weight", "last")):
        torch.cat([getattr(h, name) for h in rows],
                  out=host_in[k * rc:(k + 1) * rc])
    prices = host_in[3 * rc:]
    prices[:e_dim].copy_(s_price)
    prices[e_dim:2 * e_dim].copy_(n_price)
    prices[2 * e_dim:].copy_(firsts)
    dev_in.copy_(host_in, non_blocking=True)

    # Outputs: [surface E*C (if asked) | idx E | best E | zero E], the
    # surface first so that it starts 16-byte aligned.
    n_surf = e_dim * c_dim if surface else 0
    host_out, dev_out = buf.outputs(n_surf + 3 * e_dim)
    a_in, a_out = dev_in.data_ptr(), dev_out.data_ptr()
    p_prices, p_dec = a_in + 12 * rc, a_out + 4 * n_surf
    _ttl_kernel._launch(
        device, a_in, a_in + 4 * rc, a_in + 8 * rc, 0 if r_dim == 1 else c_dim,
        buf.edges.data_ptr(), p_prices, p_prices + 4 * e_dim,
        p_prices + 8 * e_dim, a_out if surface else None, p_dec,
        p_dec + 4 * e_dim, p_dec + 8 * e_dim, e_dim, c_dim)
    host_out.copy_(dev_out, non_blocking=True)
    torch.cuda.current_stream(device).synchronize()

    dec = host_out[n_surf:]
    idx = dec[:e_dim].long()
    best = dec[e_dim:2 * e_dim].view(F32).to(F64)
    full = None
    if surface:
        zero = dec[2 * e_dim:].view(F32)
        full = torch.cat([zero[:, None],
                          host_out[:n_surf].view(F32).view(e_dim, c_dim)], dim=1)
    return buf.candidates[idx], best, full


#: Engines :func:`ttl_scan_from_histograms` runs: the kernel (its plain
#: version when ``device`` is the CPU), or the plain float32 version.
SCAN_ENGINES = ("kernel", "torch32")


def ttl_scan_from_histograms(
    histograms, cost_model, targets,
    engine: str = "kernel",
    device="cuda",
):
    """Batched TTL selection for problems built from
    :class:`repro_torch.core.histogram.AccessHistogram` objects.

    ``histograms`` -- list of AccessHistogram (one per problem, target-side);
    ``targets``    -- list of (src_region, dst_region) edges aligned with it;
    ``engine``     -- "kernel" (the CUDA kernel on ``device``) or "torch32"
                      (the plain float32 version, on the CPU).

    Returns ``(best_ttl [E], best_cost [E], cost_surface [E, C+1])`` as
    float64 CPU tensors.  TTLs are resolved by canonical argmin *index*
    against the float64 candidate grid ``[0, edges...]``, so the returned TTL
    values are exact candidate boundaries, never float32 roundings of them.

    Raises ``ValueError`` if the histograms do not share one cell layout: a
    silent mismatch would price every row against the wrong boundaries.
    """
    from ..core.costmodel import GB, SECONDS_PER_MONTH

    if engine not in SCAN_ENGINES:
        raise ValueError(f"unknown ttl_scan engine {engine!r}; have "
                         f"{SCAN_ENGINES}")
    dev = resolve_device(device) if engine == "kernel" else CPU
    s = torch.tensor([cost_model.storage_price(dst) / GB / SECONDS_PER_MONTH
                      for (_src, dst) in targets], dtype=F64)
    n = torch.tensor([cost_model.egress_price(src, dst) / GB
                      for (src, dst) in targets], dtype=F64)
    ttls, costs, surface = _ttl_decide(histograms, s, n, dev, surface=True)
    return ttls, costs, surface.to(F64)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def flash_attention(
    q: torch.Tensor,             # [B, Hq, Sq, D]
    k: torch.Tensor,             # [B, Hkv, Skv, D]
    v: torch.Tensor,             # [B, Hkv, Skv, D]
    causal: bool = True,
    q_offset: int = 0,
) -> torch.Tensor:
    """GQA-aware fused attention -> ``[B, Hq, Sq, D]`` in q's dtype, where
    the tensors lie: the kernel on a CUDA device, its plain version on the
    CPU.

    Query head ``h`` attends KV head ``h // (Hq // Hkv)``: the kernel reads
    it in place, where the TPU wrapper repeats K/V.  The (B, H) fold and the
    ``[B, H, S, D]`` layout are strided views of the kernel's
    ``[B, S, H, D]``, so nothing is copied.  The TPU tiling knobs
    (``block_q``, ``block_kv``) are the kernel's own here.
    """
    def swap(x):
        return x.transpose(1, 2)

    return swap(flash_attention_bshd(swap(q), swap(k), swap(v),
                                     causal=causal, q_offset=q_offset))


def rwkv6_scan(r, k, v, w, u, state=None):
    """RWKV6 recurrence: the plain scan :func:`ref.rwkv6_ref`, where the
    tensors lie.  The reference has no kernel for it either (a
    ``lax.scan``): the recurrence is bandwidth-bound."""
    return ref.rwkv6_ref(r, k, v, w, u, state)
