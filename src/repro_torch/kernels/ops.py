"""Public wrappers around the port's kernels.

Each op accepts natural shapes (numpy arrays or tensors), places them on the
requested device as float32, runs the kernel there -- its plain version when
the device is the CPU -- and keeps the epilogue (the TTL = 0 column, the
argmin, the tie rule) in plain PyTorch, as the JAX reference does.
"""

from __future__ import annotations

import torch

from .ttl_scan import ttl_cost_surface

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
    CPU), where candidate 0 is TTL=0 (evict immediately) and candidate j+1
    is TTL=edges[j].  The surface is the kernel's on a CUDA device and its
    plain version on the CPU.
    """
    if device is None:
        device = hist.device if isinstance(hist, torch.Tensor) else CPU

    def put(x):
        return torch.as_tensor(x, dtype=F32, device=device).contiguous()

    hist, time_w, last, edges = (put(x) for x in (hist, time_w, last, edges))
    s_price, n_price, first_remote = (put(x) for x in
                                      (s_price, n_price, first_remote))
    surface = ttl_cost_surface(hist, time_w, last, edges, s_price, n_price,
                               first_remote)

    # Candidate TTL=0: every re-read pays N; no storage at all.
    zero = (first_remote + hist.sum(dim=1)) * n_price
    full = torch.cat([zero[:, None], surface], dim=1)
    idx = torch.argmin(full, dim=1)
    ttls = torch.cat([edges.new_zeros(1), edges])
    return ttls[idx], full.gather(1, idx[:, None])[:, 0], full


#: Relative band for canonicalizing float32 argmin ties.  Exact cost-tie
#: plateaus exist in real surfaces (zero misses and zero censored tail beyond
#: a cell make consecutive candidates *exactly* equal in float64); float32
#: rounding wobble can then move a plain argmin off the plateau start.  Any
#: band in 2**-22 .. 2**-18 recovers the float64 plateau-start index on the
#: replay-harvested corpus; 2**-20 sits in the middle of that range.
TIE_BAND = 2.0 ** -20


def _canonical_argmin(surface: torch.Tensor) -> torch.Tensor:
    """First index within ``TIE_BAND`` of each row minimum, in float64 on the
    CPU.

    This is the decision rule every float32 engine shares so that the chosen
    *index* -- and therefore the float64 candidate TTL it maps to -- matches
    the pure-float64 ``choose_ttl`` argmin even on exact-tie plateaus.
    (``torch.argmax`` takes no bool tensor; on the cast mask it returns the
    first maximal index, as ``np.argmax`` does.)
    """
    surf = surface.to(device=CPU, dtype=F64)
    mn = surf.min(dim=1, keepdim=True).values
    return torch.argmax((surf <= mn * (1.0 + TIE_BAND)).to(torch.uint8), dim=1)


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
    first_h = histograms[0]
    for h in histograms[1:]:
        first_h._check_layout(h)
    edges = first_h.edges
    hist = torch.stack([h.hist for h in histograms])
    time_w = torch.stack([h.time_weight for h in histograms])
    last = torch.stack([h.last for h in histograms])
    first = torch.tensor([h.first_read_remote_bytes for h in histograms],
                         dtype=F64)
    s = torch.tensor([cost_model.storage_price(dst) / GB / SECONDS_PER_MONTH
                      for (_src, dst) in targets], dtype=F64)
    n = torch.tensor([cost_model.egress_price(src, dst) / GB
                      for (src, dst) in targets], dtype=F64)
    _ttl32, _cost32, surface = ttl_scan(hist, time_w, last, edges, s, n,
                                        first, device=dev)
    surface = surface.to(device=CPU, dtype=F64)
    idx = _canonical_argmin(surface)
    candidates = torch.cat([edges.new_zeros(1), edges.to(F64)])
    return (candidates[idx], surface[torch.arange(idx.shape[0]), idx],
            surface)
