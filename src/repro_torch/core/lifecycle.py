"""Cloud lifecycle-rule export (paper §4.2, the alternative eviction path).

The PyTorch port's copy of :mod:`repro.core.lifecycle`, compiled from the
port's :class:`~repro_torch.core.ttl_policy.AdaptiveTTLController`.

    "Alternatively, configuring lifecycle policies for objects in each
     bucket could remove the need for SkyStore to track TTLs, although
     these policies are typically limited to 1000 rules per bucket."

This module compiles the adaptive controller's learned per-(bucket, edge)
TTLs into provider lifecycle configurations (S3 `Expiration`-style rules on
key prefixes), quantizing TTLs to whole days (the providers' granularity)
and enforcing the 1000-rules-per-bucket cap by merging the closest TTLs.
The trade-off the paper names is visible in the output: day-granularity
loses the sub-day TTLs that the §3.2.3 per-second cells enable, and the
report quantifies that rounding error.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Dict, List

from .ttl_policy import AdaptiveTTLController

DAY = 24 * 3600.0
MAX_RULES_PER_BUCKET = 1000


@dataclasses.dataclass
class LifecycleRule:
    rule_id: str
    prefix: str                 # key prefix the rule applies to
    expiration_days: int        # provider granularity: whole days, >= 1
    source_ttl_seconds: float   # what the controller actually wanted

    @property
    def rounding_error_seconds(self) -> float:
        return self.expiration_days * DAY - self.source_ttl_seconds


def compile_rules(
    ctl: AdaptiveTTLController,
    region: str,
    prefix_of=lambda bucket: f"{bucket}/",
) -> Dict[str, List[LifecycleRule]]:
    """Compile learned edge TTLs targeting ``region`` into per-bucket rules.

    Since a provider rule cannot depend on *which* source region still holds
    a replica, we take the conservative (max-availability) choice the paper
    implies: the MINIMUM TTL across incoming edges, matching the §3.3.1
    object-TTL rule for the fullest replica set."""
    per_bucket: Dict[str, List[LifecycleRule]] = {}
    ttls: Dict[str, float] = {}
    for (bucket, src, dst), edge in ctl.edge_ttls.items():
        if dst != region:
            continue
        cur = ttls.get(bucket)
        ttls[bucket] = edge.ttl_seconds if cur is None else min(
            cur, edge.ttl_seconds)
    for bucket, ttl in sorted(ttls.items()):
        days = max(1, int(math.ceil(ttl / DAY)))
        per_bucket.setdefault(bucket, []).append(
            LifecycleRule(f"skystore-{bucket}", prefix_of(bucket), days, ttl))
    return per_bucket


def enforce_rule_cap(
    rules: List[LifecycleRule], cap: int = MAX_RULES_PER_BUCKET
) -> List[LifecycleRule]:
    """Merge rules with the closest expirations until <= cap (the provider
    limit the paper calls out).  Merging keeps the SHORTER expiry: storing
    less is the safe direction (a premature refetch costs N once; an
    over-retained replica bleeds storage forever)."""
    rules = sorted(rules, key=lambda r: r.expiration_days)
    while len(rules) > cap:
        # merge the adjacent pair with the smallest day gap
        gaps = [(rules[i + 1].expiration_days - rules[i].expiration_days, i)
                for i in range(len(rules) - 1)]
        _, i = min(gaps)
        a, b = rules[i], rules[i + 1]
        merged = LifecycleRule(
            f"{a.rule_id}+{b.rule_id}"[:255],
            _common_prefix(a.prefix, b.prefix),
            min(a.expiration_days, b.expiration_days),
            min(a.source_ttl_seconds, b.source_ttl_seconds),
        )
        rules[i:i + 2] = [merged]
    return rules


def _common_prefix(a: str, b: str) -> str:
    n = 0
    for ca, cb in zip(a, b):
        if ca != cb:
            break
        n += 1
    return a[:n]


def to_s3_json(rules: List[LifecycleRule]) -> str:
    """AWS `put-bucket-lifecycle-configuration` payload."""
    return json.dumps({
        "Rules": [
            {
                "ID": r.rule_id,
                "Status": "Enabled",
                "Filter": {"Prefix": r.prefix},
                "Expiration": {"Days": r.expiration_days},
            }
            for r in rules
        ]
    }, indent=1)


def fidelity_report(rules: List[LifecycleRule]) -> Dict[str, float]:
    """How much the provider's day-granularity gives up vs adaptive TTLs."""
    if not rules:
        return {"rules": 0, "max_rounding_s": 0.0, "mean_rounding_s": 0.0}
    errs = [r.rounding_error_seconds for r in rules]
    return {
        "rules": len(rules),
        "max_rounding_s": max(errs),
        "mean_rounding_s": sum(errs) / len(errs),
        "subday_ttls_lost": sum(1 for r in rules
                                if r.source_ttl_seconds < DAY),
    }
