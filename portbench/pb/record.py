"""What one run hands from its system module to the harness, the reference and
the per-layer readers."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional


@dataclasses.dataclass
class RunRecord:
    #: End-to-end numbers the run measured, by metric name.
    e2e: Dict[str, float] = dataclasses.field(default_factory=dict)
    #: Data requests (or served requests) the window attempted and failed.
    attempted: int = 0
    failed: int = 0
    memory_peak_bytes: int = 0
    #: Host times in microseconds, by span name (traced runs).
    host_us: Dict[str, List[float]] = dataclasses.field(default_factory=dict)
    #: Counts the run made (requests, steps, hits, ...).
    counters: Dict[str, Any] = dataclasses.field(default_factory=dict)
    #: Each timed call of interest with its shape (traced runs), by name.
    calls: Dict[str, List[dict]] = dataclasses.field(default_factory=dict)
    #: Host spans (start ns, end ns, label) on the wall clock (traced runs).
    spans: List[tuple] = dataclasses.field(default_factory=list)
    #: The configuration file the run served (readers count FLOPs from it).
    config: Dict[str, Any] = dataclasses.field(default_factory=dict)
    #: The device trace reduced (traced runs): see ``trace.reduce_profile``.
    trace: Optional[dict] = None
    #: What the reference is handed to compare, by system.
    outputs: Dict[str, Any] = dataclasses.field(default_factory=dict)
