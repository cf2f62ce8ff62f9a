"""Fault tolerance + elasticity control plane (the port of
``repro.distributed.fault_tolerance``).

On a real fleet this logic lives in the job controller; here it is an
in-process state machine wired to the *actual* SkyStore-backed checkpoint
manager, so the recovery paths it exercises are the real ones:

  * heartbeats -> failure detection (grace window);
  * node/pod failure -> restore latest manifested checkpoint, possibly into a
    *different region* (SkyStore replicate-on-read pays the cheapest edge and
    caches for the next restart -- the paper's §1 training example);
  * region outage drill -> physical bytes of an entire region deleted;
    restores must come from surviving replicas (tests assert this);
  * elastic re-mesh -> recompute the data-parallel assignment for a smaller/
    larger healthy set (weights live region-redundant in the store, so any
    mesh can pull them);
  * straggler mitigation -> deterministic work reassignment: each step's
    shard list is a pure function of (step, healthy hosts, flagged
    stragglers), so every host computes the same assignment with no extra
    coordination; chronically slow hosts get demoted to backup consumers.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import time
from typing import Any, Dict, List, Optional, Tuple

from ..train.checkpoint import CheckpointManager


@dataclasses.dataclass
class Host:
    name: str
    region: str
    last_heartbeat: float
    healthy: bool = True
    slow_strikes: int = 0


class FleetController:
    def __init__(
        self,
        ckpt: CheckpointManager,
        grace_seconds: float = 30.0,
        straggler_factor: float = 2.0,
        demote_after: int = 3,
        clock=time.monotonic,
    ):
        self.ckpt = ckpt
        self.grace = grace_seconds
        self.straggler_factor = straggler_factor
        self.demote_after = demote_after
        self.clock = clock
        self.hosts: Dict[str, Host] = {}
        self.events: List[Tuple[float, str]] = []

    # -- membership -------------------------------------------------------------
    def register(self, name: str, region: str) -> None:
        self.hosts[name] = Host(name, region, self.clock())

    def heartbeat(self, name: str, step_seconds: Optional[float] = None,
                  median_step: Optional[float] = None) -> None:
        h = self.hosts[name]
        h.last_heartbeat = self.clock()
        if step_seconds is not None and median_step:
            if step_seconds > self.straggler_factor * median_step:
                h.slow_strikes += 1
                if h.slow_strikes >= self.demote_after:
                    self._log(f"demote straggler {name}")
            else:
                h.slow_strikes = 0

    def detect_failures(self) -> List[str]:
        now = self.clock()
        failed = []
        for h in self.hosts.values():
            if h.healthy and now - h.last_heartbeat > self.grace:
                h.healthy = False
                failed.append(h.name)
                self._log(f"failure detected: {h.name} ({h.region})")
        return failed

    def healthy_hosts(self) -> List[Host]:
        return [h for h in self.hosts.values()
                if h.healthy and h.slow_strikes < self.demote_after]

    # -- recovery ---------------------------------------------------------------
    def recover(self, like: Any, into_region: Optional[str] = None) -> Tuple[int, Any]:
        """Restore the latest manifested checkpoint (possibly cross-region:
        SkyStore serves from the cheapest surviving replica and caches it for
        subsequent restarts in the same region)."""
        step = self.ckpt.latest_step()
        if step is None:
            raise FileNotFoundError("no checkpoint to recover from")
        tree = self.ckpt.restore(step=step, region=into_region, like=like)
        self._log(f"recovered step {step} into "
                  f"{into_region or self.ckpt.region}")
        return step, tree

    # -- elastic data assignment ---------------------------------------------------
    def assignment(self, step: int, n_shards: int) -> Dict[str, List[int]]:
        """Deterministic shard->host map over the current healthy set.  Pure
        function of (step, membership): every host computes it locally."""
        hosts = sorted(h.name for h in self.healthy_hosts())
        if not hosts:
            return {}
        out: Dict[str, List[int]] = {h: [] for h in hosts}
        for i in range(n_shards):
            # rotate by step so a straggler's shard moves to a new host each
            # step instead of re-hitting the same slow path
            out[hosts[(i + step) % len(hosts)]].append(i)
        return out

    def elastic_mesh_shape(self, chips_per_host: int = 4,
                           model_parallel: int = 16) -> Tuple[int, int]:
        """(data, model) mesh for the healthy set: model parallelism is fixed
        by the layer shapes; the data axis absorbs the shrink/grow."""
        chips = len(self.healthy_hosts()) * chips_per_host
        data = max(1, chips // model_parallel)
        return data, model_parallel

    def _log(self, msg: str) -> None:
        self.events.append((self.clock(), msg))


def kill_region(backends: Dict[str, Any], region: str) -> int:
    """Region outage drill: wipe the physical bytes of one region.  Returns
    the number of objects destroyed.  Used by tests to prove restores come
    from surviving replicas."""
    be = backends[region]
    n = 0
    if hasattr(be, "_data"):
        n = len(be._data)
        be._data.clear()
    elif hasattr(be, "root"):
        for bucket in list(os.listdir(be.root)):
            shutil.rmtree(os.path.join(be.root, bucket), ignore_errors=True)
            n += 1
    return n
