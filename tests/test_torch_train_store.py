"""Training through the store: the port's data sources, checkpoints, fleet
recovery and training driver against the JAX package's, on the CPU.

- ``SyntheticTokens``: batches equal.
- ``SkyStoreShardSource`` over both packages' stores (one virtual clock
  each, the same regions): batches equal, the transfer log's dollars within
  1e-12 and every shard's ETag and size equal.
- ``CheckpointManager``: for the same tree, f32 and with a bf16 leaf, the
  object keys, the manifest JSON and every object's bytes equal to the
  reference's; a checkpoint written by either package's manager restores
  through the other's (bf16 bit for bit from the manifest's dtype); the
  retention GC keeps the same steps.
- ``FleetController`` / ``kill_region``: the seven cases of
  ``tests/test_checkpoint_ft.py``, on the port.
- The trainer half of ``tests/test_system.py``: 6 steps on shards served
  through the store from the same params, losses within 1e-5 relative of
  the reference's, then a checkpoint, a recovery into a third region, the
  first region killed, a second recovery bit-equal to the saved params and
  one more finite step.
- ``python -m repro_torch.launch.train --device cpu`` with and without
  ``--checkpoint-every`` and ``--use-skystore-data``: exit 0.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as r_get_config
from repro.core import VirtualStore as RVirtualStore
from repro.core import make_backends as r_make_backends
from repro.core import pick_regions as r_pick_regions
from repro.distributed.fault_tolerance import FleetController as RFleetController
from repro.models import init_params as r_init_params
from repro.train import CheckpointManager as RCheckpointManager
from repro.train import SkyStoreShardSource as RShardSource
from repro.train import SyntheticTokens as RSyntheticTokens
from repro.train import init_train_state as r_init_train_state
from repro.train import make_optimizer as r_make_optimizer
from repro.train import make_train_step as r_make_train_step
from repro_torch.configs import get_config
from repro_torch.core import VirtualStore, make_backends, pick_regions
from repro_torch.distributed.fault_tolerance import FleetController, kill_region
from repro_torch.models import params_from_reference
from repro_torch.train import (CheckpointManager, SkyStoreShardSource,
                               SyntheticTokens, init_train_state,
                               make_optimizer, make_train_step)
from repro_torch.tree import leaves_with_path

ROOT = Path(__file__).resolve().parents[1]


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def port_store():
    cat = pick_regions(3)
    be = make_backends(list(cat.region_names()), "memory")
    return cat, be, VirtualStore(cat, be, mode="FB", clock=FakeClock(),
                                 device="cpu")


def ref_store():
    cat = r_pick_regions(3)
    be = r_make_backends(list(cat.region_names()), "memory")
    return cat, be, RVirtualStore(cat, be, mode="FB", clock=FakeClock())


def as_numpy(t):
    if isinstance(t, torch.Tensor) and t.dtype == torch.bfloat16:
        return t.float().numpy().astype(ml_dtypes.bfloat16)
    return np.asarray(t)


# ---------------------------------------------------------------------------
# Data sources
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_tokens_equal(seed):
    got, want = SyntheticTokens(256, 16, 4, seed), RSyntheticTokens(256, 16, 4, seed)
    for _ in range(4):
        a, b = next(got), next(want)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
            assert a[k].dtype == b[k].dtype == np.int32


def test_shard_source_over_both_stores():
    cat, _be, vs = port_store()
    rcat, _rbe, rvs = ref_store()
    base, west, _euro = cat.region_names()
    assert (base, west) == tuple(rcat.region_names()[:2])
    for store in (vs, rvs):
        cls = SkyStoreShardSource if store is vs else RShardSource
        cls.write_corpus(store, "corpus", base, n_shards=5,
                         tokens_per_shard=3 * 17 + 7, vocab=256, seed=2)
    src = SkyStoreShardSource(vs, "corpus", west, batch=3, seq_len=16)
    rsrc = RShardSource(rvs, "corpus", west, batch=3, seq_len=16)
    assert src._keys == rsrc._keys
    for i in range(12):           # 12 x 51 tokens: every shard read 2-3 times
        vs._clock.t = rvs._clock.t = 3600.0 * i
        a, b = next(src), next(rsrc)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
        assert abs(vs.transfers.dollars - rvs.transfers.dollars) <= 1e-12
    assert vs.transfers.dollars > 0
    assert src.epoch_bytes == rsrc.epoch_bytes
    for key in src._keys:
        h, rh = vs.head_object("corpus", key), rvs.head_object("corpus", key)
        assert (h.etag, h.size) == (rh.etag, rh.size)
        assert vs.replica_regions("corpus", key) == rvs.replica_regions("corpus", key)


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

def ckpt_tree(bf16=False):
    rng = np.random.default_rng(0)
    tree = {
        "layer": {"w": np.arange(12, dtype=np.float32).reshape(3, 4),
                  "b": np.zeros(4, np.float32)},
        "step_arr": np.int32(7),
        "blocks": {"pos0": {"mixer": {"wq": rng.standard_normal((2, 5, 3))
                                      .astype(np.float32)}}},
    }
    if bf16:
        tree["embed"] = {"w": rng.standard_normal((6, 4)).astype(ml_dtypes.bfloat16)}
    return tree


def port_tree(tree):
    """The tree as the port holds it: tensors (bf16 for bf16 leaves)."""
    def conv(x):
        x = np.asarray(x)
        if x.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
        return torch.from_numpy(np.array(x))
    return jax.tree.map(conv, tree)


def objects(backend):
    return {k: data for k, (data, _h) in backend._data.items()}


@pytest.mark.parametrize("bf16", [False, True])
def test_checkpoint_objects_byte_equal(bf16):
    cat, be, vs = port_store()
    _rcat, rbe, rvs = ref_store()
    west = cat.region_names()[1]
    tree = ckpt_tree(bf16)
    CheckpointManager(vs, "ckpt", west, name="m").save(4, port_tree(tree))
    RCheckpointManager(rvs, "ckpt", west, name="m").save(4, tree)
    got, want = objects(be[west]), objects(rbe[west])
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key] == want[key], key
    key = "m/manifest/00000004/shard0000.json"
    man = json.loads(vs.get_object("ckpt", key, west))
    assert man == json.loads(rvs.get_object("ckpt", key, west))
    if bf16:
        assert {e["key"]: e["dtype"] for e in man["leaves"]}["embed/w"] == "bfloat16"
    for k in vs.list_objects("ckpt"):
        assert vs.head_object("ckpt", k).etag == rvs.head_object("ckpt", k).etag


@pytest.mark.parametrize("bf16", [False, True])
def test_checkpoints_restore_across_packages(bf16):
    tree = ckpt_tree(bf16)
    # The port's manager restores what the reference's wrote ...
    _rcat, _rbe, rvs = ref_store()
    a, b, _ = _rcat.region_names()
    RCheckpointManager(rvs, "ckpt", a).save(3, tree)
    back = CheckpointManager(rvs, "ckpt", a).restore(region=b, like=tree)
    for path, leaf in leaves_with_path(back):
        want = tree
        for k in path:
            want = want[k]
        assert isinstance(leaf, torch.Tensor)
        got, want = as_numpy(leaf), np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert got.tobytes() == want.tobytes(), path
    # ... and the reference's restores what the port's wrote, as it restores
    # its own (a bf16 leaf comes back as its raw '<V2' words either way).
    _cat, _be, vs = port_store()
    CheckpointManager(vs, "ckpt", a).save(3, port_tree(tree))
    RCheckpointManager(rvs, "ckpt2", a).save(3, tree)
    mine = RCheckpointManager(vs, "ckpt", a).restore(region=b, like=tree)
    own = RCheckpointManager(rvs, "ckpt2", a).restore(region=b, like=tree)
    for x, y in zip(jax.tree.leaves(mine), jax.tree.leaves(own)):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()
    flat = CheckpointManager(vs, "ckpt", a).restore()
    assert sorted(flat) == sorted("/".join(p) for p, _ in leaves_with_path(tree))


def test_retention_gc_matches_reference():
    cat, _be, vs = port_store()
    _rcat, _rbe, rvs = ref_store()
    a = cat.region_names()[0]
    ck, rck = CheckpointManager(vs, "ckpt", a, keep=2), RCheckpointManager(rvs, "ckpt", a, keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, port_tree(ckpt_tree()))
        rck.save(s, ckpt_tree())
        assert vs.list_objects("ckpt") == rvs.list_objects("ckpt")
    steps = {int(k.split("/")[-2])
             for k in vs.list_objects("ckpt", prefix="model/manifest/")}
    assert steps == {3, 4} and ck.latest_step() == rck.latest_step() == 4


# ---------------------------------------------------------------------------
# tests/test_checkpoint_ft.py, on the port
# ---------------------------------------------------------------------------

@pytest.fixture
def store():
    cat = pick_regions(3)
    be = make_backends(list(cat.region_names()), "memory")
    vs = VirtualStore(cat, be, mode="FB", device="cpu")
    return cat, be, vs


def tree():
    return {
        "layer": {"w": np.arange(12, dtype=np.float32).reshape(3, 4),
                  "b": np.zeros(4, np.float32)},
        "step_arr": np.int32(7),
    }


def test_checkpoint_roundtrip(store):
    cat, be, vs = store
    a = cat.region_names()[0]
    ck = CheckpointManager(vs, "ckpt", a)
    t = tree()
    ck.save(10, t)
    back = ck.restore(like=t)
    for (_p, x), (_q, y) in zip(leaves_with_path(t), leaves_with_path(back)):
        np.testing.assert_array_equal(x, y.numpy())
    assert ck.latest_step() == 10


def test_cross_region_restore_pays_egress_once(store):
    cat, be, vs = store
    a, b, _ = cat.region_names()
    ck = CheckpointManager(vs, "ckpt", a)
    ck.save(1, tree())
    before = vs.transfers.dollars
    ck.restore(region=b, like=tree())       # remote restore: pays egress
    mid = vs.transfers.dollars
    assert mid > before
    ck.restore(region=b, like=tree())       # replicas cached: free now
    assert vs.transfers.dollars == pytest.approx(mid)


def test_region_outage_drill(store):
    cat, be, vs = store
    a, b, _ = cat.region_names()
    ck = CheckpointManager(vs, "ckpt", a)
    t = tree()
    ck.save(5, t)
    ck.restore(region=b, like=t)            # replicate everything to b
    assert kill_region(be, a) > 0           # region a is gone
    back = ck.restore(region=b, like=t)     # b's replicas serve the restore
    np.testing.assert_array_equal(back["layer"]["w"].numpy(), t["layer"]["w"])


def test_retention_gc(store):
    cat, be, vs = store
    a = cat.region_names()[0]
    ck = CheckpointManager(vs, "ckpt", a, keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, tree())
    steps = {int(k.split("/")[-2])
             for k in vs.list_objects("ckpt", prefix="model/manifest/")}
    assert steps == {3, 4}


def test_fleet_failure_detection_and_recovery(store):
    cat, be, vs = store
    a, b, _ = cat.region_names()
    ck = CheckpointManager(vs, "ckpt", a)
    ck.save(42, tree())

    now = [0.0]
    fc = FleetController(ck, grace_seconds=10.0, clock=lambda: now[0])
    for i in range(4):
        fc.register(f"host{i}", a if i < 2 else b)
    now[0] = 15.0
    for i in range(3):
        fc.heartbeat(f"host{i}")
    now[0] = 20.0                      # host3 silent past the grace window
    failed = fc.detect_failures()
    assert failed == ["host3"]
    step, t = fc.recover(like=tree(), into_region=b)
    assert step == 42

    a1 = fc.assignment(step=1, n_shards=8)
    a2 = fc.assignment(step=1, n_shards=8)
    assert a1 == a2
    assert sorted(sum(a1.values(), [])) == list(range(8))
    assert "host3" not in a1
    assert fc.assignment(step=2, n_shards=8) != a1    # rotates each step


def test_straggler_demotion(store):
    cat, be, vs = store
    ck = CheckpointManager(vs, "ckpt", cat.region_names()[0])
    now = [0.0]
    fc = FleetController(ck, straggler_factor=2.0, demote_after=2,
                         clock=lambda: now[0])
    fc.register("fast", "r")
    fc.register("slow", "r")
    for _ in range(3):
        fc.heartbeat("fast", step_seconds=1.0, median_step=1.0)
        fc.heartbeat("slow", step_seconds=5.0, median_step=1.0)
    names = [h.name for h in fc.healthy_hosts()]
    assert names == ["fast"]


def test_elastic_mesh_shrinks(store):
    cat, be, vs = store
    ck = CheckpointManager(vs, "ckpt", cat.region_names()[0])
    now = [0.0]
    fc = FleetController(ck, grace_seconds=1.0, clock=lambda: now[0])
    for i in range(64):
        fc.register(f"h{i}", "r")
    assert fc.elastic_mesh_shape(chips_per_host=4) == (16, 16)
    now[0] = 10.0                      # everyone times out except 32 hosts
    for i in range(32):
        fc.heartbeat(f"h{i}")
    fc.detect_failures()
    assert fc.elastic_mesh_shape(chips_per_host=4) == (8, 16)


def test_fleet_controller_matches_reference():
    """Events, failures, assignments and mesh shapes equal the reference's
    on one scripted run."""
    runs = []
    for fc_cls, mk in ((FleetController, port_store), (RFleetController, ref_store)):
        cat, _be, vs = mk()
        ck = (CheckpointManager if fc_cls is FleetController
              else RCheckpointManager)(vs, "ckpt", cat.region_names()[0])
        now = [0.0]
        fc = fc_cls(ck, grace_seconds=5.0, straggler_factor=1.5,
                    demote_after=2, clock=lambda: now[0])
        for i in range(6):
            fc.register(f"h{i}", cat.region_names()[i % 3])
        out = []
        for t in range(1, 8):
            now[0] = 2.0 * t
            for i in range(6 - t // 3):
                fc.heartbeat(f"h{i}", step_seconds=1.0 + (i == 1), median_step=1.0)
            out.append((fc.detect_failures(), fc.assignment(t, 7),
                        fc.elastic_mesh_shape(2, 2)))
        runs.append((out, fc.events))
    assert runs[0] == runs[1]


# ---------------------------------------------------------------------------
# tests/test_system.py's trainer half, on the port
# ---------------------------------------------------------------------------

def test_end_to_end_train_checkpoint_failover():
    """Train a reduced model on shards served through SkyStore, checkpoint
    into one region, kill that region, recover from surviving replicas in
    another region, and keep training -- beside the reference doing the
    same from the same params."""
    cat, be, vs = port_store()
    rcat, rbe, rvs = ref_store()
    base, west, euro = cat.region_names()

    r_cfg = r_get_config("llama3.2-1b").reduced()
    cfg = get_config("llama3.2-1b").reduced()
    RShardSource.write_corpus(rvs, "corpus", base, n_shards=4,
                              tokens_per_shard=4 * 17 * 2, vocab=r_cfg.vocab)
    SkyStoreShardSource.write_corpus(vs, "corpus", base, n_shards=4,
                                     tokens_per_shard=4 * 17 * 2,
                                     vocab=cfg.vocab)
    rsrc = RShardSource(rvs, "corpus", west, batch=4, seq_len=16)
    src = SkyStoreShardSource(vs, "corpus", west, batch=4, seq_len=16)

    rparams = r_init_params(jax.random.PRNGKey(0), r_cfg)
    _, r_opt = r_make_optimizer("adamw", lr=3e-3, warmup_steps=1)
    r_step = jax.jit(r_make_train_step(r_cfg, r_opt))
    r_state = r_init_train_state(r_cfg, rparams, r_opt)
    params = params_from_reference(jax.tree.map(np.asarray, rparams), cfg,
                                   device="cpu")
    _, opt = make_optimizer("adamw", lr=3e-3, warmup_steps=1)
    step = make_train_step(cfg, opt)
    state = init_train_state(cfg, params, opt)

    ck = CheckpointManager(vs, "ckpt", west, name=cfg.name)
    r_losses, losses = [], []
    for i, batch, rbatch in zip(range(6), src, rsrc):
        for k in batch:
            np.testing.assert_array_equal(batch[k], rbatch[k])
        r_state, r_m = r_step(r_state, {k: jnp.asarray(v)
                                        for k, v in rbatch.items()})
        state, m = step(state, {k: torch.from_numpy(v)
                                for k, v in batch.items()})
        r_losses.append(float(r_m["loss"]))
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, r_losses, rtol=1e-5, atol=0)
    assert abs(vs.transfers.dollars - rvs.transfers.dollars) <= 1e-12
    ck.save(6, state.params)

    # replicate the checkpoint into euro by restoring there once
    fc = FleetController(ck)
    _step, _ = fc.recover(like=state.params, into_region=euro)

    # region outage: west's physical bytes are gone
    kill_region(be, west)
    step_no, restored = fc.recover(like=state.params, into_region=euro)
    assert step_no == 6
    for (pa, a), (pb, b) in zip(leaves_with_path(restored),
                                leaves_with_path(state.params)):
        assert pa == pb and a.dtype == b.dtype
        assert torch.equal(a, b), pa

    # resume training from the restored params
    state2 = init_train_state(cfg, restored, opt)
    state2, metrics = step(state2, {k: torch.from_numpy(v)
                                    for k, v in next(src).items()})
    assert bool(torch.isfinite(metrics["loss"]))


# ---------------------------------------------------------------------------
# The training driver
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flags", [
    [],
    ["--checkpoint-every", "3"],
    ["--use-skystore-data"],
    ["--checkpoint-every", "3", "--use-skystore-data", "--microbatches", "2"],
])
def test_launch_train_on_cpu(tmp_path, flags):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--steps", "6", "--store-root", str(tmp_path), *flags],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("done.")
    assert ("checkpointed step 6" in out.stdout) == ("--checkpoint-every" in flags)
    assert ("egress paid" in out.stdout) == ("--use-skystore-data" in flags)
