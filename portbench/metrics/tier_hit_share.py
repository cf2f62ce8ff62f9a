"""Share of the window's KV-tier lookups that found the prefix's caches
(``KVTierManager.stats``: hits over hits and misses), in percent."""


def read(run):
    n = run.counters.get("tier_lookups", 0)
    return 100.0 * run.counters["tier_hits"] / n if n else None
