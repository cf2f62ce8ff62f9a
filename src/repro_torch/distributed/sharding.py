"""Logical-axis sharding rules (MaxText-style) for DP/FSDP/TP/EP/SP.

The port of ``repro.distributed.sharding``.  Models annotate tensors with
*logical* axis names ("batch", "d_model", "heads", "experts", ...).  A
:class:`ShardingRules` table maps logical names to mesh axes; the same model
code then runs under any mesh by swapping rule tables.

Default production rules (16 x 16 "data" x "model" mesh, optionally with a
leading "pod" axis):

  batch         -> ("pod", "data")     # DP across pods and the data axis
  fsdp          -> "data"              # parameter/optimizer FSDP dim
  heads/d_ff/   -> "model"             # tensor parallelism
  vocab/experts
  seq           -> None                # (sequence parallelism: set to "data"
                                       #  for long-context decode, batch=1)

``long_context_rules`` flips batch/seq so a 500k-token cache shards over the
data axis (SP) while batch=1 replicates.

A spec is the reference's ``PartitionSpec`` as a plain tuple: one entry per
tensor dim, ``None``, a mesh axis name or a tuple of names, so the two
compare directly.  On a :class:`~torch.distributed.device_mesh.DeviceMesh`
a fitted spec becomes DTensor placements (:func:`to_placements`).  Where the
reference's ``with_sharding_constraint`` lets XLA's partitioner move data,
:func:`shard` redistributes a DTensor itself; and where XLA inserts the FSDP
all-gather of a parameter at its use, the model calls :func:`gather_fsdp`.
Both return their argument at once on a plain tensor or outside
:func:`use_rules`, whose rules and mesh hold for the calling thread only
(:func:`carried` takes them to a checkpoint's recompute on autograd's
device thread).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional, Sequence, Tuple, Union

import torch

from ..tree import tree_map

Entry = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Entry, ...]


class _Context(threading.local):
    """The current rules and mesh, per thread (the reference's are too).
    The autograd engine runs a CUDA backward, and with it the recompute of
    a checkpointed block, on a device thread of its own: such a function
    carries the forward's rules there (:func:`carried`)."""

    rules: Optional["ShardingRules"] = None
    mesh = None


_CTX = _Context()


class ShardingRules(dict):
    """logical axis name -> mesh axis (str | tuple | None)."""

    def spec(self, logical: Sequence[Optional[str]]) -> Spec:
        parts = []
        used = set()
        for name in logical:
            if name is None:
                parts.append(None)
                continue
            mesh_axes = self.get(name)
            if mesh_axes is None:
                parts.append(None)
                continue
            if isinstance(mesh_axes, str):
                mesh_axes = (mesh_axes,)
            # A mesh axis may appear at most once in a spec.
            mesh_axes = tuple(a for a in mesh_axes if a not in used)
            used.update(mesh_axes)
            parts.append(mesh_axes if len(mesh_axes) > 1 else
                         (mesh_axes[0] if mesh_axes else None))
        return tuple(parts)


def base_rules(multi_pod: bool = False) -> ShardingRules:
    dp = ("pod", "data") if multi_pod else ("data",)
    return ShardingRules(
        batch=dp,
        seq=None,
        kv_seq=None,
        d_model=None,
        heads="model",
        kv_heads="model",
        head_dim=None,
        d_ff="model",
        vocab="model",
        experts=None,
        expert_ff="model",
        fsdp="data",
        kv_lora=None,
        conv=None,
        state=None,
        layers=None,
        frames=None,
        attn_q=None,        # q-sequence axis of attention score tiles: set to
                            # "model" for archs whose head counts cannot shard
    )


def long_context_rules(multi_pod: bool = False) -> ShardingRules:
    """Sequence parallelism for batch=1, 500k-token decode: the KV cache
    shards over BOTH mesh axes along the sequence dim (524288 / 512 = 1024
    per rank); batch=1 stays replicated."""
    r = base_rules(multi_pod)
    r["batch"] = None
    r["seq"] = "data"
    r["kv_seq"] = (("pod", "data", "model") if multi_pod
                   else ("data", "model"))
    return r


# -- the current rules ----------------------------------------------------------

@contextlib.contextmanager
def use_rules(rules: ShardingRules, mesh=None):
    prev, prev_mesh = _CTX.rules, _CTX.mesh
    _CTX.rules, _CTX.mesh = rules, mesh
    try:
        yield rules
    finally:
        _CTX.rules, _CTX.mesh = prev, prev_mesh


def current_rules() -> Optional[ShardingRules]:
    return _CTX.rules


def carried(fn):
    """``fn``, run under the rules and mesh current where it was wrapped,
    on whatever thread calls it: the function a checkpoint recomputes in
    the backward.  Outside :func:`use_rules`, ``fn`` itself."""
    rules, mesh = _CTX.rules, _CTX.mesh
    if rules is None and mesh is None:
        return fn

    def run(*args, **kwargs):
        with use_rules(rules, mesh):
            return fn(*args, **kwargs)

    return run


def axis_sizes(mesh) -> dict:
    """{mesh axis name: size}: a DeviceMesh's, or ``mesh.shape`` where that
    is already such a dict (the reference's ``Mesh.shape``)."""
    if isinstance(mesh.shape, dict):
        return dict(mesh.shape)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _fit_spec(mesh, spec: Spec, shape: Tuple[int, ...]) -> Spec:
    """Drop mesh axes that do not evenly divide their dimension (e.g. 8 KV
    heads over a 16-way model axis): the entry degrades to replicated rather
    than erroring, so one rule table serves every architecture."""
    sizes = axis_sizes(mesh)
    parts = []
    for i, entry in enumerate(spec):
        if entry is None or i >= len(shape):
            parts.append(entry)
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        n = 1
        for a in axes:
            n *= sizes[a]
        parts.append(entry if shape[i] % n == 0 else None)
    return tuple(parts)


def to_placements(mesh, spec: Spec) -> tuple:
    """DTensor placements, one per mesh dim, for a spec: a mesh axis named
    by tensor dim ``i``'s entry shards dim ``i``; the others replicate.  An
    entry naming several axes shards its dim over them in mesh order."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate()] * len(mesh.mesh_dim_names)
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        for a in ((entry,) if isinstance(entry, str) else entry):
            out[mesh.mesh_dim_names.index(a)] = Shard(i)
    return tuple(out)


def placements_for(mesh, rules: ShardingRules, axes, shape) -> tuple:
    """The placements of one tensor of ``shape`` with logical ``axes``."""
    return to_placements(mesh, _fit_spec(mesh, rules.spec(axes), tuple(shape)))


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(a, (str, type(None)))
                                        for a in x)


def logical_sharding(mesh, rules: ShardingRules, axes_tree, shape_tree):
    """Trees of (logical-axes tuples, tensors or shapes) -> a tree of
    placements, divisibility-aware (the reference's ``NamedSharding`` tree
    for jit's in/out shardings)."""
    return tree_map(
        lambda axes, st: placements_for(mesh, rules, axes,
                                        getattr(st, "shape", st)),
        axes_tree, shape_tree, is_leaf=_is_axes)


def replicated(mesh) -> tuple:
    return to_placements(mesh, ())


def shard(x, logical: Sequence[Optional[str]]):
    """Constrain an activation to its logical axes: a DTensor is
    redistributed to the current rules' placements.  A plain tensor, or any
    tensor outside a :func:`use_rules` context with a mesh, comes back as
    it is, so models run unmodified on one device."""
    mesh = _CTX.mesh
    if mesh is None:
        return x
    return _redistribute(x, mesh, lambda: placements_for(
        mesh, _CTX.rules, logical, x.shape))


def gather_fsdp(w):
    """A parameter at its use: a DTensor loses its sharding over the mesh
    axes of the ``fsdp`` rule (the all-gather FSDP does before a layer, and
    XLA's partitioner inserts for the reference); its other placements
    stay.  A plain tensor, or any outside :func:`use_rules`, comes back as
    it is."""
    mesh = _CTX.mesh
    if mesh is None:
        return w
    fsdp = _CTX.rules.get("fsdp")
    axes = (fsdp,) if isinstance(fsdp, str) else tuple(fsdp or ())

    def target():
        from torch.distributed.tensor import Replicate

        return tuple(Replicate() if n in axes and p.is_shard() else p
                     for n, p in zip(mesh.mesh_dim_names, w.placements))

    return _redistribute(w, mesh, target)


def _redistribute(x, mesh, placements):
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    want = placements()
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


def placed_like(x, like):
    """``x`` in ``like``'s placements: a DTensor gradient redistributed to
    its parameter's (a partial sum reduce-scattered where the parameter is
    split).  A plain ``x``, or one placed so already, comes back as it is."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor) or tuple(x.placements) == tuple(
            like.placements):
        return x
    return x.redistribute(like.device_mesh, like.placements)


def local_like(like, *pairs):
    """For each ``(x, dims)`` of ``pairs``, x's dim ``j`` spanning
    ``like``'s dim ``dims[j]``: the part of ``x`` that lines up with
    ``like``'s local shard -- split as ``like`` splits those dims, whole
    along the others -- as a plain tensor.  Math on these broadcasts as it
    would on whole tensors, in ``like``'s placement (DTensor broadcasts in
    one of its own choosing).  A plain ``like``: the x's as they are."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(like, DTensor):
        return tuple(x for x, _ in pairs)
    out = []
    for x, dims in pairs:
        dims = list(dims)
        want = tuple(Shard(dims.index(p.dim)) if p.is_shard() and p.dim in dims
                     else Replicate() for p in like.placements)
        out.append(x.redistribute(like.device_mesh, want).to_local())
    return tuple(out)


def from_local_like(t, like):
    """``t``, computed on ``like``'s local shard, as a DTensor placed as
    ``like`` is; with a plain ``like``, ``t`` itself."""
    from torch.distributed.tensor import DTensor

    if not isinstance(like, DTensor):
        return t
    return DTensor.from_local(t, like.device_mesh, like.placements,
                              run_check=False)


def elementwise(fn, x):
    """``fn(x)`` for an elementwise ``fn``.  A DTensor ``x`` computes it on
    its local shard and keeps its placements (a pending partial sum is
    reduced first): torch 2.11's DTensor has no rule for some elementwise
    ops (``softplus``) and replicates their operand to run them."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return fn(x)
    x = _resolve_partial(x)
    return DTensor.from_local(fn(local_of(x)), x.device_mesh, x.placements,
                              run_check=False)


def write_seq(cache, start: int, new) -> None:
    """``cache[:, start:start + S] = new`` in place, for ``new`` [B, S, ...]:
    a decode step's cache write.  On a DTensor cache whose sequence dim is
    split over mesh axes, each rank writes the part of ``new`` that falls
    in its own slice of the sequence (its local shard), as a partitioned
    dynamic-update-slice does: the cache never moves between ranks."""
    s = new.shape[1]
    if _CTX.mesh is None or getattr(cache, "placements", None) is None:
        cache[:, start:start + s] = new
        return
    from torch.distributed.tensor import Replicate

    mesh = cache.device_mesh
    split = [i for i, p in enumerate(cache.placements)
             if p.is_shard() and p.dim == 1]
    new = new.redistribute(mesh, tuple(
        Replicate() if i in split else p
        for i, p in enumerate(cache.placements))).to_local()
    local = cache.to_local()
    width = local.shape[1]
    first = split_start(mesh, split, width)
    lo, hi = max(start, first), min(start + s, first + width)
    if lo < hi:
        local[:, lo - first:hi - first] = new[:, lo - start:hi - start]


def split_microbatches(x, n: int):
    """``x`` [B, ...] as ``n`` microbatches of B / n rows, indexable by
    microbatch: the reshape ``[n, B / n, ...]`` of a plain tensor (row
    block ``i`` is microbatch ``i``).  A DTensor splits each rank's local
    rows the same way, as a data loader feeds each rank its own
    microbatches: no rows move between ranks, and the gradient summed over
    the microbatches is the whole batch's all the same."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor) or x.to_local().shape[0] % n:
        return x.reshape((n, x.shape[0] // n) + tuple(x.shape[1:]))
    local = x.to_local()
    parts = local.reshape((n, local.shape[0] // n) + tuple(local.shape[1:]))
    return [DTensor.from_local(parts[i], x.device_mesh, x.placements,
                               run_check=False) for i in range(n)]


class _RowMajor(torch.autograd.Function):
    """Identity that hands on a row-major tensor both ways: a local shard
    going into plain code, and its gradient coming back.  A gradient left
    in the permuted layout an einsum's backward makes reaches DTensor's
    ``view`` in the next op's backward, which torch 2.11 refuses on such
    strides."""

    @staticmethod
    def forward(ctx, x):
        return x.contiguous()

    @staticmethod
    def backward(ctx, grad):
        return grad.contiguous()


def local_of(x, grad_placements=None):
    """This rank's shard of the DTensor ``x``, row-major, its gradient
    row-major too (:class:`_RowMajor`).  ``grad_placements`` declares how
    the gradients of the ranks' shards combine (``Partial`` on an axis
    over which ``x`` is replicated but each rank uses it on different data:
    their gradients sum); by default as ``x`` is placed."""
    return _RowMajor.apply(x.to_local(grad_placements=grad_placements))


def _partial_where(x, split_by):
    """``x``'s placements, with ``Partial`` on the axes where ``x`` is
    replicated and ``split_by`` (placements) splits the work."""
    from torch.distributed.tensor import Partial

    return tuple(Partial() if p.is_replicate() and q.is_shard() else p
                 for p, q in zip(x.placements, split_by))


def _resolve_partial(x):
    """``x`` with any pending (partial-sum) placement reduced."""
    from torch.distributed.tensor import Replicate

    if not any(p.is_partial() for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, tuple(
        Replicate() if p.is_partial() else p for p in x.placements))


def split_start(mesh, dims, width: int) -> int:
    """This rank's first index along a tensor dim split over mesh ``dims``
    (mesh order: the outer axis first) into blocks of ``width``."""
    coord = mesh.get_coordinate()
    idx = 0
    for i in dims:
        idx = idx * mesh.size(i) + coord[i]
    return idx * width


def _pick_split(x, index, dim: int, index_to, out_to, pick):
    """``pick(local x, local index shifted into x's slice, inside)`` where
    ``x``'s dim ``dim`` may be split over mesh axes: each rank picks the
    indices that fall in its slice (zero elsewhere), and the result is a
    partial sum over those axes.  ``index_to(i, p)`` / ``out_to(i, p)``
    give the index's and the result's placement on the other mesh axes
    (``p`` is x's placement there)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    x = _resolve_partial(x)
    mesh = x.device_mesh
    if not isinstance(index, DTensor):
        index = DTensor.from_local(index, mesh, (Replicate(),) * mesh.ndim,
                                   run_check=False)
    split = [i for i, p in enumerate(x.placements)
             if p.is_shard() and p.dim == dim]
    index = index.redistribute(mesh, tuple(
        Replicate() if i in split else index_to(i, p)
        for i, p in enumerate(x.placements)))
    local = local_of(x, _partial_where(x, index.placements))
    idx = index.to_local().long()
    width = local.shape[dim]
    first = split_start(mesh, split, width)
    inside = (idx >= first) & (idx < first + width)
    picked = pick(local, (idx - first).clamp(0, width - 1), inside)
    return DTensor.from_local(picked, mesh, tuple(
        Partial() if i in split else out_to(i, p)
        for i, p in enumerate(x.placements)), run_check=False)


def take_last(x, index):
    """``x[..., index]`` for ``x`` [..., V] and integer ``index`` [...]:
    the gold logit of a cross-entropy.  A DTensor ``x`` whose last dim is
    split over mesh axes (vocab-parallel logits) takes it as Megatron's
    vocab-parallel loss does: each rank picks the indices that fall in its
    slice (zero elsewhere), and the result is a partial sum over those
    axes, reduced where it is next needed -- no rank gathers the logits."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(x, DTensor):
        return x.gather(-1, index[..., None].long())[..., 0]
    last = x.dim() - 1

    def lead(_i, p):                   # the index splits as x's leading dims
        return p if p.is_shard() and p.dim < last else Replicate()

    def pick(local, idx, inside):
        got = local.gather(-1, idx[..., None])[..., 0]
        return torch.where(inside, got, 0.0)

    return _pick_split(x, index, last, lead, lead, pick)


def logsumexp_last(x):
    """``torch.logsumexp(x, -1)``.  A DTensor ``x`` whose last dim is split
    over mesh axes (vocab-parallel logits) reduces it where it lies: the
    row max and the sum of exponentials are all-reduced over those axes,
    and no rank gathers the logits."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    last = x.dim() - 1
    split = ([i for i, p in enumerate(x.placements)
              if p.is_shard() and p.dim == last]
             if isinstance(x, DTensor) else [])
    if not split:
        return torch.logsumexp(x, dim=-1)
    x = _resolve_partial(x)
    mesh = x.device_mesh
    rest = tuple(Replicate() if i in split else p
                 for i, p in enumerate(x.placements))
    local = local_of(x)

    def reduce(t, op):
        part = DTensor.from_local(t, mesh, tuple(
            Partial(op) if i in split else p for i, p in enumerate(rest)),
            run_check=False)
        return part.redistribute(mesh, rest).to_local()

    top = reduce(local.detach().amax(-1), "max")
    total = reduce(torch.exp(local - top[..., None]).sum(-1), "sum")
    return DTensor.from_local(top + torch.log(total), mesh, rest,
                              run_check=False)


def embed_rows(w, tokens):
    """Rows of the table ``w`` [V, D] at integer ``tokens``: ``w[tokens]``.
    A DTensor table split over its rows (the vocab axis) is read as a
    vocab-parallel embedding: each rank reads the tokens in its slice and
    the rows sum over those axes.  The tokens keep their own split over
    the other axes (the batch), unless the table splits D there."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(w, DTensor):
        return w[tokens]
    if not isinstance(tokens, DTensor):
        tokens = DTensor.from_local(tokens, w.device_mesh,
                                    (Replicate(),) * w.device_mesh.ndim,
                                    run_check=False)
    own = tokens.placements
    nd = tokens.dim()

    def index_to(i, p):
        return Replicate() if p.is_shard() else own[i]

    def out_to(i, p):
        return Shard(nd) if p.is_shard() else own[i]

    def pick(local, idx, inside):
        return local[idx] * inside[..., None].to(local.dtype)

    return _pick_split(w, tokens, 0, index_to, out_to, pick)


def batch_local(x):
    """(``x``'s rows on this rank as a plain tensor, every other dim whole;
    a function turning such a local tensor back into a DTensor split over
    the batch as ``x`` is).  A plain ``x`` comes back as it is, with the
    identity."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(x, DTensor):
        return x, _same
    mesh = x.device_mesh
    keep = tuple(p if p.is_shard() and p.dim == 0 else Replicate()
                 for p in x.placements)
    local = local_of(x.redistribute(mesh, keep))
    return local, lambda t: DTensor.from_local(t, mesh, keep,
                                               run_check=False)


def whole(t, like):
    """All of ``t`` on this rank as a plain tensor (a DTensor gathered);
    a plain ``t`` as it is.  Each rank uses it on the rows of ``like``'s
    batch it holds, so its gradient sums over the axes that split them."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(t, DTensor):
        return t
    full = t.redistribute(t.device_mesh, (Replicate(),) * t.device_mesh.ndim)
    return local_of(full, _partial_where(full, tuple(
        p if p.is_shard() and p.dim == 0 else Replicate()
        for p in like.placements)))


def batch_mean(x, like):
    """``x``, a mean over this rank's rows of the batch ``like`` is split
    over, as the mean over the whole batch (every rank holds as many rows).
    For a plain ``like``, ``x`` itself."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(like, DTensor):
        return x
    mesh = like.device_mesh
    rows = tuple(Shard(0) if p.is_shard() and p.dim == 0 else Replicate()
                 for p in like.placements)
    return DTensor.from_local(x[None], mesh, rows, run_check=False).mean(0)


def _same(t):
    return t
