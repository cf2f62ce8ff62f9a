"""Multi-pod dry-run: trace every (architecture x input shape) cell on the
production meshes.

The port of ``repro.launch.dryrun``.  Where the reference lowers and
compiles each cell's step for 512 forced host devices, this runs the *real*
step -- the same ``make_train_step`` / ``serve_step`` / ``forward(mode=
"prefill")`` the examples run -- on the fake process group of 256 or 512
ranks (:func:`repro_torch.launch.mesh.init_fake_world`), under
``FakeTensorMode`` on ``device`` (no memory, no kernels), with parameters,
optimizer state, caches and inputs as DTensors placed by the logical-axis
rules.  Attention takes the plain ``_sdpa`` (``plain_attention=True``), which
is what the reference's dry-run lowers.  For each valid cell it records:

  * ``memory``: the bytes one rank holds of the arguments and of the
    outputs (their local shards), the most the step's own tensors held at
    once (``temp_size_in_bytes``), and their sum ``total_hbm_bytes``;
  * ``hlo``: per-device FLOPs, bytes and collective bytes from
    :mod:`repro_torch.launch.step_analysis` (feeds :mod:`.roofline`);
  * ``microbatches``.

A cell that cannot be traced reports ``ok: false`` with its error; the
sweep goes on.

CLI (one process a mesh is safest: some torch versions keep stale process
groups when the fake world is rebuilt; ``--both-meshes`` runs every 16 x 16
cell before the first 2 x 16 x 16 one):
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b \\
        --shape train_4k --multi-pod
    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --cell llama3.2-1b:train_4k --cell gemma3-4b:decode_32k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out dryrun.json
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import time
from typing import Any, Dict, Optional

import torch

from ..configs import (
    ARCH_NAMES, SHAPE_NAMES, ModelConfig, ShapeConfig, cell_is_valid,
    get_config, get_shape,
)
from ..distributed.sharding import (
    base_rules, long_context_rules, placements_for, shard, use_rules,
)
from ..kernels.ops import resolve_device
from ..models import forward, param_axes, cache_axes
from ..models.layers import dtype_of
from ..models.transformer import (_cache_leaf_dtype, _map_specs, cache_schema,
                                  model_schema)
from ..serve.decode import serve_step
from ..train.optimizer import make_optimizer, opt_state_axes
from ..train.trainer import TrainState, make_train_step
from ..tree import tree_map
from . import step_analysis
from .mesh import init_fake_world, make_production_mesh


# ---------------------------------------------------------------------------
# Input specs
# ---------------------------------------------------------------------------

def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """Model inputs for one cell: {name: ((shape, dtype), logical axes)}."""
    b, s = shape.global_batch, shape.seq_len
    if shape.input_kind == "decode":
        return {"tokens": (((b, 1), torch.int32), ("batch", None))}
    if cfg.frontend:
        specs = {"inputs": (((b, s, cfg.frontend_dim), dtype_of(cfg.act_dtype)),
                            ("batch", "seq", None))}
    else:
        specs = {"inputs": (((b, s), torch.int32), ("batch", "seq"))}
    if shape.input_kind == "train":
        specs["labels"] = (((b, s), torch.int32), ("batch", "seq"))
    return specs


def pick_microbatches(cfg: ModelConfig, shape: ShapeConfig, dp: int) -> int:
    """Grad-accum depth: big models need small per-microbatch token counts;
    the microbatch global batch must still cover the DP axis."""
    if shape.input_kind != "train":
        return 1
    if cfg.microbatches_train:
        want = cfg.microbatches_train
    else:
        n = cfg.param_count()
        want = 16 if n > 2e10 else 8 if n > 5e9 else 4 if n > 2e9 else 1
    return max(1, min(want, shape.global_batch // dp))


def rules_for(cfg: ModelConfig, shape: ShapeConfig, multi_pod: bool):
    if shape.name == "long_500k":
        return long_context_rules(multi_pod)
    r = base_rules(multi_pod)
    # Megatron-SP-style residual sharding keeps big-model activations O(D/TP)
    r["d_model"] = "model"
    if cfg.moe is not None and cfg.moe.n_routed % 16 == 0:
        # True expert parallelism over the model axis: the dispatch buffer
        # and expert weights co-shard on the expert dim.  Guarded on
        # divisibility -- qwen2's 60 experts keep EP-via-TP.
        r["experts"] = "model"
        r["expert_ff"] = None
    if cfg.n_heads % 16 != 0 and shape.input_kind != "decode":
        # Q heads cannot shard 16-way at all (coder 56h, gemma 8h, vl 28h):
        # context-parallel the attention score tiles over the model axis.
        r["attn_q"] = "model"
        r["kv_heads"] = None
        r["heads"] = None
    if shape.input_kind in ("decode", "prefill"):
        # KV caches dominate decode/prefill memory.  Shard heads over the
        # model axis when divisible; otherwise (GQA kv<16, or MLA's
        # head-free latent cache) shard the cache's sequence dim.
        if cfg.n_kv_heads % 16 != 0 or cfg.mla is not None:
            r["kv_seq"] = "model"
            if shape.input_kind == "decode":
                r["kv_heads"] = None
    return r


# ---------------------------------------------------------------------------
# Cell tracing
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CellResult:
    arch: str
    shape: str
    mesh: str
    ok: bool
    seconds: float
    error: str = ""
    memory: Dict[str, float] = dataclasses.field(default_factory=dict)
    hlo: Dict[str, Any] = dataclasses.field(default_factory=dict)
    microbatches: int = 1

    def to_json(self):
        return dataclasses.asdict(self)


def _empty_tree(schema, dtype_of_leaf, device):
    """Fake (global-shape) tensors for a schema tree."""
    return _map_specs(lambda path, sp: torch.empty(
        sp.shape, dtype=dtype_of_leaf(path, sp), device=device), schema)


def _place(mesh, rules, tree, axes_tree):
    """Each tensor of ``tree`` as a DTensor placed by its logical axes."""
    from torch.distributed.tensor import distribute_tensor

    return tree_map(
        lambda x, axes: distribute_tensor(
            x, mesh, placements_for(mesh, rules, axes, x.shape)),
        tree, axes_tree)


def _place_one(mesh, rules, x, axes):
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(x, mesh, placements_for(mesh, rules, axes, x.shape))


def _inputs(cfg, shape, mesh, rules, device):
    out = {}
    for name, ((shp, dtype), axes) in input_specs(cfg, shape).items():
        x = torch.zeros(shp, dtype=dtype, device=device)
        out[name] = _place_one(mesh, rules, x, axes)
    return out


def _params(cfg, mesh, rules, device, serving: bool):
    """Parameters in ``cfg.param_dtype``; serving runs bf16 checkpoints
    (the activation dtype) regardless of the training param dtype."""
    pdt = dtype_of(cfg.param_dtype)
    adt = dtype_of(cfg.act_dtype)
    dt = adt if (serving and pdt == torch.float32) else pdt
    glob = _empty_tree(model_schema(cfg), lambda _p, _sp: dt, device)
    return glob, _place(mesh, rules, glob, param_axes(cfg))


def _caches(cfg, shape, mesh, rules, device):
    b, s = shape.global_batch, shape.seq_len
    glob = _empty_tree(cache_schema(cfg, b, s),
                       lambda path, _sp: _cache_leaf_dtype(path[-1], cfg),
                       device)
    return _place(mesh, rules, glob, cache_axes(cfg, b, s))


def trace_train(cfg, shape, mesh, rules, device,
                mb_override: Optional[int] = None):
    dp = 1
    for name, size in zip(mesh.mesh_dim_names, mesh.shape):
        if name in ("data", "pod"):
            dp *= size
    mb = mb_override or pick_microbatches(cfg, shape, dp)
    okw = {"use_master": False} if cfg.pure_bf16 else {}
    ocfg, opt = make_optimizer(cfg.optimizer, **okw)
    accum = "bfloat16" if cfg.param_count() > 1e11 else "float32"
    step = make_train_step(cfg, opt, microbatches=mb, accum_dtype=accum)

    params_g, params = _params(cfg, mesh, rules, device, serving=False)
    opt_g = opt.init(params_g)
    o_axes = opt_state_axes(ocfg, params_g, param_axes(cfg))
    opt_state = _place(mesh, rules, opt_g, o_axes)
    del params_g, opt_g
    step_t = _place_one(mesh, rules,
                        torch.zeros((), dtype=torch.int32, device=device), ())
    state = TrainState(params, opt_state, step_t)
    batch = _inputs(cfg, shape, mesh, rules, device)
    args = (state.params, state.opt_state, step_t, batch)

    def run():
        new_state, metrics = step(state, batch)
        return (new_state.params, new_state.opt_state, new_state.step,
                metrics)

    return run, args, mb


def trace_decode(cfg, shape, mesh, rules, device):
    _, params = _params(cfg, mesh, rules, device, serving=True)
    caches = _caches(cfg, shape, mesh, rules, device)
    tokens = _inputs(cfg, shape, mesh, rules, device)["tokens"]
    pos = shape.seq_len - 1

    def run():
        return serve_step(cfg, params, caches, tokens, pos,
                          plain_attention=True)

    return run, (params, caches, tokens), 1


def trace_prefill(cfg, shape, mesh, rules, device):
    _, params = _params(cfg, mesh, rules, device, serving=True)
    inputs = _inputs(cfg, shape, mesh, rules, device)["inputs"]

    c_axes = cache_axes(cfg, shape.global_batch, shape.seq_len)

    def run():
        # The outputs leave in the reference's out_shardings: the logits
        # over ("batch", "vocab") (an encoder's over its sequence too), the
        # caches over ``cache_axes``; any reshard they need is counted.
        if cfg.encoder_only:
            logits, _, _ = forward(cfg, params, inputs, mode="train",
                                   remat=False, plain_attention=True)
            return shard(logits, ("batch", "seq", "vocab"))
        logits, caches, _ = forward(cfg, params, inputs, mode="prefill",
                                    plain_attention=True)
        return (shard(logits[:, -1], ("batch", "vocab")),
                tree_map(shard, caches, c_axes))

    return run, (params, inputs), 1


def _memory(args, out, peak: float) -> Dict[str, float]:
    """Per-rank bytes: arguments, outputs (those that alias an argument, as
    decode's caches written in place, counted once), the step's peak of its
    own tensors, and the total the rank must hold."""
    arg_storages = {getattr(t, "_local_tensor", t).untyped_storage()._cdata
                    for t in step_analysis._tensors(args)}
    arg_b = step_analysis.tree_local_bytes(args)
    out_b = alias_b = 0.0
    for t in step_analysis._tensors(out):
        local = getattr(t, "_local_tensor", t)
        n = step_analysis.nbytes(local)
        out_b += n
        if local.untyped_storage()._cdata in arg_storages:
            alias_b += n
    mem = {"argument_size_in_bytes": arg_b, "output_size_in_bytes": out_b,
           "alias_size_in_bytes": alias_b, "temp_size_in_bytes": peak}
    mem["total_hbm_bytes"] = arg_b + max(peak, out_b - alias_b)
    return mem


@contextlib.contextmanager
def _index_math_off_fake():
    """DTensor works out a strided shard's offsets with small index tensors
    it makes and reads back (``tolist``); under ``FakeTensorMode`` those
    would be fake and unreadable.  Run that one computation on real
    tensors (it allocates a few int64 of the dim's size)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import placement_types as pt

    cls = getattr(pt, "_StridedShard", None)
    fn = getattr(cls, "local_shard_size_and_offset", None)
    if fn is None:
        yield
        return

    @functools.wraps(fn)
    def real(*a, **k):
        with unset_fake_temporarily():
            return fn(*a, **k)

    cls.local_shard_size_and_offset = real
    try:
        yield
    finally:
        cls.local_shard_size_and_offset = fn


def trace_cell(cfg, shape, mesh, rules, device, mb_override=None) -> tuple:
    """Trace one step of ``shape``'s kind for ``cfg`` on ``mesh`` (a
    DeviceMesh over a fake group) under ``rules``: (memory, hlo,
    microbatches), as :class:`CellResult` records them."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication

    with FakeTensorMode(), implicit_replication(), \
            _index_math_off_fake(), use_rules(rules, mesh):
        if shape.input_kind == "train":
            run, args, mb = trace_train(cfg, shape, mesh, rules, device,
                                        mb_override=mb_override)
        elif shape.input_kind == "decode":
            run, args, mb = trace_decode(cfg, shape, mesh, rules, device)
        else:
            run, args, mb = trace_prefill(cfg, shape, mesh, rules, device)
        out, hlo = step_analysis.analyze(run)
        return _memory(args, out, hlo["peak_bytes"]), hlo, mb


def run_cell(arch: str, shape_name: str, multi_pod: bool, device="cuda",
             mb_override: Optional[int] = None) -> CellResult:
    t0 = time.time()
    mesh_name = "2x16x16" if multi_pod else "16x16"
    valid, reason = cell_is_valid(arch, shape_name)
    if not valid:
        return CellResult(arch, shape_name, mesh_name, False, 0.0,
                          error=f"SKIP: {reason}")
    dev = resolve_device(device)
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    rules = rules_for(cfg, shape, multi_pod)
    try:
        init_fake_world(512 if multi_pod else 256)
        mesh = make_production_mesh(multi_pod=multi_pod, device=dev)
        memory, hlo, mb = trace_cell(cfg, shape, mesh, rules, dev,
                                     mb_override)
        return CellResult(arch, shape_name, mesh_name, True,
                          time.time() - t0, memory=memory, hlo=hlo,
                          microbatches=mb)
    except Exception as e:  # noqa: BLE001 -- report, don't crash the sweep
        return CellResult(arch, shape_name, mesh_name, False,
                          time.time() - t0, error=f"{type(e).__name__}: {e}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=ARCH_NAMES)
    ap.add_argument("--shape", choices=SHAPE_NAMES)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--cell", action="append", default=[],
                    metavar="ARCH:SHAPE", help="a cell to trace (repeatable)")
    ap.add_argument("--all", action="store_true",
                    help="sweep every valid cell on this mesh")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=None, help="write JSON results here")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cells = []
    if args.all:
        for a in ARCH_NAMES:
            for s in SHAPE_NAMES:
                cells.append((a, s))
    elif args.cell:
        cells = [tuple(c.split(":", 1)) for c in args.cell]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape, --cell or --all")
        cells = [(args.arch, args.shape)]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    results = []
    for mp in meshes:
        for a, s in cells:
            r = run_cell(a, s, mp, device=args.device)
            results.append(r)
            status = "OK " if r.ok else ("SKIP" if r.error.startswith("SKIP")
                                         else "FAIL")
            hbm = r.memory.get("total_hbm_bytes", 0) / 2**30
            print(f"[{status}] {a:24s} {s:12s} {r.mesh:8s} "
                  f"{r.seconds:6.1f}s hbm/dev={hbm:6.2f}GiB "
                  f"flops/dev={r.hlo.get('flops', 0):.3e} "
                  f"coll/dev={r.hlo.get('collective_bytes', 0):.3e} "
                  f"{r.error[:80]}", flush=True)
            if r.ok:
                print("    memory:", json.dumps(r.memory), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump([r.to_json() for r in results], f, indent=1)
        print(f"wrote {args.out}")
    n_fail = sum(1 for r in results
                 if not r.ok and not r.error.startswith("SKIP"))
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
