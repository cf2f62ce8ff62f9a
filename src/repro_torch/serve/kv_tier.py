"""TTL-driven KV/prefix-cache tier manager (DESIGN.md §5 hardware adaptation).

The paper's core calculus -- capacity is effectively unbounded, but *storing*
a replica costs S per byte-time while *re-fetching* it costs N per byte, so
keep a replica exactly while its re-use distance beats T_even = N/S -- maps
verbatim onto the TPU serving tiers:

    region  <->  tier        "storage price"            "egress price"
    -------------------------------------------------------------------
    hbm          HBM         $/GB-month of occupied     PCIe transfer time
    host         host DRAM   accelerator/host memory    valued at chip-time
    store        object st.  (tpu_tier_catalog)         rates

Prefix-cache blocks (tokenized prompt prefixes and their KV pages) are the
"objects"; a serving fleet re-reading a hot system prompt is the repeated-GET
workload of §1.  The same :class:`AdaptiveTTLController` (histograms, argmin
scan, reset-on-access) decides how long an evicted-from-HBM block lingers in
host DRAM before falling to the object tier -- no new machinery, just a new
cost catalog, which is precisely the paper's portability claim.

This module manages *metadata + block placement*; actual page movement is the
caller's concern (the decode loop hands in block handles).

The port of ``repro.serve.kv_tier``: it runs on the port's controller, whose
refreshes use the TTL-scan kernel on ``device`` (default the card; pass
``device="cpu"`` for the float64 engine on the CPU).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..core.costmodel import CostModel, tpu_tier_catalog
from ..core.ttl_policy import AdaptiveTTLController

TIERS = ("tier:hbm", "tier:host", "tier:store")


@dataclasses.dataclass
class Block:
    key: str                   # e.g. hash of the token prefix
    nbytes: int
    tier: str
    last_access: float
    ttl: float
    payload: Any = None        # opaque handle (device array, host buffer, ...)

    @property
    def expire(self) -> float:
        return self.last_access + self.ttl


class KVTierManager:
    """Adaptive-TTL placement of KV blocks across HBM / host / store tiers."""

    def __init__(
        self,
        catalog: Optional[CostModel] = None,
        bucket: str = "kv",
        refresh_period: float = 60.0,
        clock=time.monotonic,
        device="cuda",
    ):
        self.cost = catalog or tpu_tier_catalog()
        self.ctl = AdaptiveTTLController(
            self.cost, refresh_period=refresh_period, warmup_min_samples=16,
            device=device)
        self.bucket = bucket
        self.blocks: Dict[str, Block] = {}
        self.clock = clock
        self.stats = {"hits": {t: 0 for t in TIERS}, "misses": 0,
                      "promotions": 0, "demotions": 0}

    # -- serving-path API --------------------------------------------------------
    def lookup(self, key: str) -> Optional[Block]:
        """Access a block: records the inter-access gap (the §3.2.2 histogram
        sample), promotes to HBM, resets the TTL."""
        now = self.clock()
        blk = self.blocks.get(key)
        if blk is None:
            self.stats["misses"] += 1
            return None
        self.stats["hits"][blk.tier] += 1
        gap = now - blk.last_access
        self.ctl.record_gap(self.bucket, blk.tier, gap, blk.nbytes)
        if blk.tier != "tier:hbm":
            self.stats["promotions"] += 1
            blk.tier = "tier:hbm"
        blk.last_access = now
        blk.ttl = self._ttl("tier:host", "tier:hbm", now)
        return blk

    def insert(self, key: str, nbytes: int, payload: Any = None) -> Block:
        now = self.clock()
        self.ctl.record_first_read(self.bucket, "tier:hbm", nbytes, remote=True)
        blk = Block(key, nbytes, "tier:hbm", now,
                    self._ttl("tier:host", "tier:hbm", now), payload)
        self.blocks[key] = blk
        return blk

    # -- background eviction scan (the §4.2 daily scan, at serving cadence) -------
    def scan(self, now: Optional[float] = None) -> List[Tuple[str, str, str]]:
        """Demote expired blocks one tier down (hbm -> host -> store);
        returns (key, from_tier, to_tier) moves for the caller to execute."""
        now = self.clock() if now is None else now
        ages, sizes = [], []
        for blk in self.blocks.values():
            ages.append(now - blk.last_access)
            sizes.append(blk.nbytes)
        if ages:
            self.ctl.set_last_snapshot(
                self.bucket, "tier:hbm", torch.tensor(ages, dtype=torch.float64),
                torch.tensor(sizes, dtype=torch.float64))
        moves = []
        for key, blk in list(self.blocks.items()):
            if blk.expire > now:
                continue
            i = TIERS.index(blk.tier)
            if i + 1 < len(TIERS):
                frm = blk.tier
                blk.tier = TIERS[i + 1]
                blk.last_access = now
                blk.ttl = self._ttl(TIERS[min(i + 2, len(TIERS) - 1)],
                                    blk.tier, now)
                self.stats["demotions"] += 1
                moves.append((key, frm, blk.tier))
            # store tier is the FB base: never dropped (sole copy rule)
        return moves

    def _ttl(self, src: str, dst: str, now: float) -> float:
        return self.ctl.edge_ttl(self.bucket, src, dst, now)

    # -- reporting -----------------------------------------------------------------
    def occupancy(self) -> Dict[str, int]:
        out = {t: 0 for t in TIERS}
        for blk in self.blocks.values():
            out[blk.tier] += blk.nbytes
        return out

    def t_even_seconds(self) -> Dict[str, float]:
        """The break-even residency per tier edge -- the §3.1.1 numbers that
        make this adaptation legible (HBM: seconds; host: hours)."""
        return {
            "host->hbm": self.cost.t_even_seconds("tier:host", "tier:hbm"),
            "store->host": self.cost.t_even_seconds("tier:store", "tier:host"),
        }
