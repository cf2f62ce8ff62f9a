"""Per-device FLOPs, bytes and collective bytes of a traced step.

The counterpart of ``repro.launch.hlo_analysis``.  Torch produces no HLO, so
nothing here parses one: :class:`StepAnalysis` is a dispatch mode that
watches a step run -- on DTensors over a (possibly fake) process group,
under ``FakeTensorMode`` or on real tensors -- and counts what each rank
does, from the ops DTensor issues on the local shards:

  * ``flops``: the products, counted as the reference's ``_dot_flops``
    counts a ``dot`` (2 x result elements x contracted size) for ``mm``,
    ``bmm``, ``addmm`` and ``baddbmm`` on the local shards;
  * ``bytes``: operands plus results of every op that touches memory (view
    and metadata ops excluded), on the local shards;
  * ``collective_bytes`` and ``collective_bytes_by_kind``: the functional
    collectives DTensor issues, with the reference's ring multipliers
    (all-reduce 2(n-1)/n x size, reduce-scatter (n-1) x result,
    all-gather and all-to-all (n-1)/n x result, a permute its size);
  * ``peak_bytes``: the most bytes the step's own tensors held at once (the
    arguments excluded), by storage, as they are made and freed; and
    ``largest_outputs``, the eight largest results one op made.

A DTensor-level op is left to DTensor (the mode steps aside), so the mode
sees the local ops it runs, its collectives included; the global-shape ops
DTensor runs to propagate tensor metadata are not counted.  Unlike the
reference's numbers there is no loop to multiply: the trace runs every
layer.  The reference's ``f32_shadow_bytes`` (copies CPU XLA makes of bf16
operands) has no counterpart and is dropped.
"""

from __future__ import annotations

import contextlib
import threading
import weakref
from collections import defaultdict
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_PROPAGATING = threading.local()

#: kind of each functional collective (the reference's HLO op names).
COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "broadcast": "collective-permute",
}
_MATMULS = ("mm", "bmm", "addmm", "baddbmm")
_FREE = ("detach", "empty", "empty_strided", "empty_like", "lift_fresh",
         "wait_tensor", "set_", "resize_", "alias", "_local_scalar_dense")


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _matmul_flops(name: str, args, out) -> float:
    if name in ("addmm", "baddbmm"):
        args = args[1:]
    a = args[0]
    return 2.0 * out.numel() * a.shape[-1]


def _group_size(name: str, args) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group

    group = args[-1]
    if isinstance(group, str):
        return _resolve_process_group(group).size()
    return int(args[-2])


@contextlib.contextmanager
def _skip_meta_propagation():
    """Mark the global-shape ops DTensor runs to propagate tensor metadata,
    so they are not counted as work."""
    from torch.distributed.tensor import _sharding_prop as sp

    cls = sp.ShardingPropagator
    name = ("_propagate_tensor_meta_non_cached"
            if hasattr(cls, "_propagate_tensor_meta_non_cached")
            else "_propagate_tensor_meta")
    orig = getattr(cls, name)

    def wrapped(self, *a, **k):
        prev = getattr(_PROPAGATING, "on", False)
        _PROPAGATING.on = True
        try:
            return orig(self, *a, **k)
        finally:
            _PROPAGATING.on = prev

    setattr(cls, name, wrapped)
    try:
        yield
    finally:
        setattr(cls, name, orig)


class StepAnalysis(TorchDispatchMode):
    """Count what one rank does while it is active; :meth:`result` gives
    the totals."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.coll: Dict[str, float] = defaultdict(float)
        self.coll_count: Dict[str, int] = defaultdict(int)
        self.coll_f32 = 0.0
        self.n_ops = 0
        self.live = 0
        self.peak = 0
        self._seen = set()
        self._largest = []                 # (bytes, op, shape), at most 8
        self._stack = contextlib.ExitStack()

    def __enter__(self):
        self._stack.enter_context(_skip_meta_propagation())
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._stack.close()

    def _track(self, out, args=()) -> None:
        """Count the storages ``out`` brings into being; one an input
        already had (an in-place op, a view) is not new."""
        had = {t.untyped_storage()._cdata for t in _tensors(args)}
        for t in _tensors(out):
            st = t.untyped_storage()
            key = st._cdata
            if key in self._seen or key in had:
                continue
            try:
                weakref.finalize(st, self._free, key, st.nbytes())
            except TypeError:
                continue
            self._seen.add(key)
            self.live += st.nbytes()
            self.peak = max(self.peak, self.live)

    def _free(self, key, n) -> None:
        self._seen.discard(key)
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if getattr(_PROPAGATING, "on", False):
            return out
        name = func._schema.name.split("::")[-1]
        ns = func.namespace
        self.n_ops += 1
        if ns in ("_c10d_functional", "_dtensor") and name in COLLECTIVES:
            self._collective(COLLECTIVES[name], name, args, out)
            self._track(out, args)
            return out
        if func.is_view or name in _FREE or ns == "prim":
            return out
        res = list(_tensors(out))
        for t in res:
            n = nbytes(t)
            if len(self._largest) < 8 or n > self._largest[-1][0]:
                self._largest = sorted(self._largest + [
                    (n, name, tuple(t.shape))], reverse=True)[:8]
        if name in _MATMULS:
            self.flops += _matmul_flops(name, args, res[0])
        moved = sum(nbytes(t) for t in res)
        moved += sum(nbytes(t) for t in _tensors(args))
        moved += sum(nbytes(t) for t in _tensors(kwargs))
        self.bytes += moved
        self._track(out, (args, kwargs))
        return out

    def _collective(self, kind: str, name: str, args, out) -> None:
        n = _group_size(name, args)
        if n <= 1:
            return
        res = next(iter(_tensors(out)))
        size = nbytes(res)
        ring = (n - 1) / n
        if kind == "all-reduce":
            moved = 2.0 * size * ring
        elif kind == "reduce-scatter":
            moved = size * (n - 1)
        elif kind == "collective-permute":
            moved = float(size)
        else:
            moved = size * ring
        self.coll[kind] += moved
        self.coll_count[kind] += 1
        if res.dtype == torch.float32:
            self.coll_f32 += moved

    def result(self) -> dict:
        return {
            "flops": self.flops,
            "bytes": self.bytes,
            "collective_bytes": float(sum(self.coll.values())),
            "collective_bytes_f32": self.coll_f32,
            "collective_bytes_by_kind": dict(self.coll),
            "collective_counts": dict(self.coll_count),
            "peak_bytes": float(self.peak),
            "largest_outputs": [list(x) for x in self._largest],
            "n_ops": self.n_ops,
        }


def analyze(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` under :class:`StepAnalysis`; returns
    (its result, the per-device totals)."""
    with StepAnalysis() as an:
        out = fn(*args, **kwargs)
    return out, an.result()


def tree_local_bytes(tree) -> float:
    """Bytes one rank holds of a tree of tensors (a DTensor's local shard)."""
    total = 0
    for t in _tensors(tree):
        local = getattr(t, "_local_tensor", t)
        total += nbytes(local)
    return float(total)
