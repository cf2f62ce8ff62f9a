"""Routed MoE over the experts a call chose: two CUDA kernels for Hopper,
their ctypes binding, the plain version and the launch counter.

``models.layers.apply_moe`` sends a call here when no (token, k) pair can be
dropped (``S * top_k <= cap``: every decode step), no gradient is needed,
the tensors are plain and :func:`fits` takes the shapes.  Then the capacity
buffer ``[B, E, cap, d]`` the reference scatters into is almost all zeros,
and reading every expert's weights for it is the layer's cost on the card;
here each expert some token chose is read once, and the shared expert
beside it.  The kernels (``csrc/moe_decode.cu``) replace no Pallas kernel:
the JAX package's ``apply_moe`` is plain jnp.  Their source note gives the
design and the byte bound.

The function, for tokens ``t`` with pairs ``(t, j)`` (expert ``e_tj``, gate
``g_tj``) and ``n_shared`` shared experts of width ``f``::

    h_tj = silu(x_t We_gate[e_tj]) * (x_t We_up[e_tj])
    h_ts = silu(x_t Ws_gate[:, s f:(s+1) f]) * (x_t Ws_up[:, s f:(s+1) f])
    y_t  = sum_j g_tj h_tj We_down[e_tj] + sum_s h_ts Ws_down[s f:(s+1) f]

every product, ``h`` and the sum in fp32, ``y`` rounded once to ``x``'s
dtype.  A token may name one expert in several pairs: each is summed with
its own gate.  Every id must lie in ``[0, E)``: the plain version raises
otherwise; the kernels cannot look at the ids without waiting for the
card, so they read nothing for such a pair and give its token a row of
NaN.  The capacity path rounds ``g``, ``u``, ``h``, each expert's output,
the routed sum and the shared expert to the model's dtype and adds the last
two there: in float32 the two agree to rounding; in bf16 this path is the
closer to an fp32 computation.

:func:`routed_moe` dispatches on where ``x`` lies: on the CPU it computes
:func:`plain`; on a CUDA device it launches both kernels or raises.  It
never falls back.  Every launch is counted in :data:`launches`.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch
import torch.nn.functional as F

from .build import CudaLibrary

#: Most tokens (``B * S``) a call may have.
MAX_TOKENS = 1024
#: d and f must be whole multiples of the narrowest tile.
TILE = 32
#: Shared memory of the gate / up kernel's block: a pass's x rows (4 tokens
#: in fp32, 16 d bytes) and two int lists of a pair each (8 bytes a pair).
SMEM_BYTES = 160 * 1024
DTYPES = (torch.float32, torch.bfloat16)

#: Kernel launches (two a call) on the card since the last reset.
launches = 0


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.moe_decode.argtypes = [ptr] * 11 + [i32] * 8 + [ptr]
    lib.moe_decode.restype = i32


LIBRARY = CudaLibrary("moe_decode", _bind)


def fits(n_tok: int, top_k: int, d: int, f: int, dtype: torch.dtype) -> bool:
    """Whether the kernels take a call of ``n_tok`` tokens of ``top_k``
    pairs at widths ``d`` and ``f`` (the expert's) in ``dtype``; the plain
    version follows the same rule, so the CPU and the card take the same
    path."""
    return (1 <= n_tok <= MAX_TOKENS and top_k >= 1 and d % TILE == 0
            and f % TILE == 0 and d > 0 and f > 0 and dtype in DTYPES
            and 16 * d + 8 * n_tok * top_k <= SMEM_BYTES)


def plain(x, expert, gates, we_gate, we_up, we_down, ws_gate=None,
          ws_up=None, ws_down=None) -> torch.Tensor:
    """The kernels' function in plain PyTorch: each pair's expert weights
    gathered, everything in fp32, ``y`` [T, d] rounded once to ``x``'s
    dtype.  ``x`` [T, d], ``expert`` [T, top_k] int64, ``gates`` [T, top_k]
    fp32; shared weights ``[d, n_shared f]`` / ``[n_shared f, d]`` or
    None.  Raises if an id lies outside ``[0, E)``."""
    n_exp, f = we_gate.shape[0], we_gate.shape[-1]
    if expert.numel() and not bool(((expert >= 0) & (expert < n_exp)).all()):
        raise ValueError(f"expert ids must lie in [0, {n_exp})")
    xf = x.float()
    g = torch.einsum("td,tkdf->tkf", xf, we_gate[expert].float())
    u = torch.einsum("td,tkdf->tkf", xf, we_up[expert].float())
    y = torch.einsum("tkf,tkfd->tkd", F.silu(g) * u, we_down[expert].float())
    y = (y * gates.float()[..., None]).sum(1)
    if ws_gate is not None:
        ns = ws_gate.shape[1] // f
        gs = (xf @ ws_gate.float()).reshape(-1, ns, f)
        us = (xf @ ws_up.float()).reshape(-1, ns, f)
        hs = (F.silu(gs) * us).reshape(-1, ns * f)
        y = y + hs @ ws_down.float()
    return y.to(x.dtype)


def _check(x, expert, gates, we_gate, we_up, we_down, shared) -> None:
    """Raise unless the kernels take these tensors: ``x`` [T, d],
    ``expert`` [T, top_k] int64, ``gates`` [T, top_k] fp32, the weights in
    ``x``'s dtype at the shapes of :func:`plain`, all on ``x``'s device,
    contiguous and 16-byte aligned.  The ids' values are the kernels'
    own to guard (see the module's docstring): a check here would wait
    for the card."""
    if x.dim() != 2 or expert.dim() != 2 or we_gate.dim() != 3:
        raise ValueError(f"want x [T, d], expert [T, top_k], we_gate "
                         f"[E, d, f]; got {tuple(x.shape)}, "
                         f"{tuple(expert.shape)}, {tuple(we_gate.shape)}")
    t, d = x.shape
    e, _d, f = we_gate.shape
    if not fits(t, expert.shape[1], d, f, x.dtype):
        raise ValueError(f"the kernels do not take T={t}, top_k="
                         f"{expert.shape[1]}, d={d}, f={f} in "
                         f"{x.dtype} (see moe_decode.fits)")
    want = [("x", x, (t, d), x.dtype),
            ("expert", expert, (t, expert.shape[1]), torch.int64),
            ("gates", gates, tuple(expert.shape), torch.float32),
            ("we_gate", we_gate, (e, d, f), x.dtype),
            ("we_up", we_up, (e, d, f), x.dtype),
            ("we_down", we_down, (e, f, d), x.dtype)]
    if shared[0] is not None:
        nsf = shared[0].shape[-1] // f * f
        want += [("ws_gate", shared[0], (d, nsf), x.dtype),
                 ("ws_up", shared[1], (d, nsf), x.dtype),
                 ("ws_down", shared[2], (nsf, d), x.dtype)]
    for name, ten, shape, dtype in want:
        if (ten.shape != shape or ten.dtype != dtype or ten.device != x.device
                or not ten.is_contiguous() or ten.data_ptr() % 16):
            raise ValueError(
                f"{name} is {tuple(ten.shape)} {ten.dtype} on {ten.device}"
                f"{'' if ten.is_contiguous() else ', not contiguous'}; want "
                f"{shape} {dtype} on {x.device}, contiguous, 16-byte aligned")


def routed_moe(x, expert, gates, we_gate, we_up, we_down, ws_gate=None,
               ws_up=None, ws_down=None) -> torch.Tensor:
    """``y`` [T, d] in ``x``'s dtype (see the module's docstring).

    CPU tensors: :func:`plain`.  CUDA tensors: the two kernels on the
    current stream (no synchronisation), counted in :data:`launches`."""
    if x.device.type == "cpu":
        return plain(x, expert, gates, we_gate, we_up, we_down, ws_gate,
                     ws_up, ws_down)
    if x.device.type != "cuda":
        raise ValueError(f"routed_moe runs on cpu or cuda, not {x.device}")
    shared = (ws_gate, ws_up, ws_down)
    _check(x, expert, gates, we_gate, we_up, we_down, shared)
    f = we_gate.shape[-1]
    index = x.device.index
    current = index is None or index == torch.cuda.current_device()
    with contextlib.nullcontext() if current else torch.cuda.device(index):
        return _launch(x, expert, gates, we_gate, we_up, we_down, shared,
                       64 if f % 64 == 0 else 32)


def _launch(x, expert, gates, we_gate, we_up, we_down, shared,
            ft: int) -> torch.Tensor:
    """Both kernels on checked inputs, the gate / up kernel at column tile
    ``ft`` (64, or 32 where 64 does not divide ``f``); counted.
    Card tests and ``chip_smoke.py`` force tiles through it."""
    global launches
    lib = LIBRARY.load()
    t, d = x.shape
    n_exp, f, k = we_gate.shape[0], we_gate.shape[-1], expert.shape[1]
    ns = 0 if shared[0] is None else shared[0].shape[1] // f
    bf16 = int(x.dtype == torch.bfloat16)
    h = torch.empty((t, k + ns, f), dtype=torch.float32, device=x.device)
    y = torch.empty((t, d), dtype=x.dtype, device=x.device)
    ws = [None if w is None else w.data_ptr() for w in shared]
    stream = torch.cuda.current_stream().cuda_stream
    err = lib.moe_decode(x.data_ptr(), expert.data_ptr(), gates.data_ptr(),
                         we_gate.data_ptr(), we_up.data_ptr(), we_down.data_ptr(),
                         *ws, h.data_ptr(), y.data_ptr(), t, k, ns, d, f, n_exp,
                         bf16, ft, stream)
    if err != 0:
        why = "arguments refused" if err == 1001 else f"cudaError {err}"
        raise RuntimeError(f"moe_decode launch failed: {why}")
    launches += 2
    return y
