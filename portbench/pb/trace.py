"""The device trace of a window, reduced to what the per-layer readers and
the result's ``breakdown`` need.

``device_profile`` in ``chip_smoke.py`` (the port's bring-up gate) summed
the profiler's kernel self times over the host's wall time; here the busy
time is the union of the device intervals, so kernels on overlapping
streams are not counted twice.  Host spans are the benchmark's own (its
wrappers around the program's calls), on the wall clock the profiler's
events are stamped with.  A device op is charged to the innermost span
that was open when the host launched it (the launch's correlation id
links the two), and each stretch of an idle gap to the innermost span open
over it.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Optional

#: Host-side runtime calls whose correlation id names the device op they
#: started.
_LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
             "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync",
             "cudaMemcpy", "cudaLaunchCooperativeKernel")


def start_profiler(cpu: bool):
    """A started ``torch.profiler`` over the device (and the host's ops if
    ``cpu``: the launches' host times come with them)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():         # a rehearsal on the CPU
        acts = [ProfilerActivity.CPU]
    else:
        acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
        torch.cuda.synchronize()
    prof = profile(activities=acts)
    prof.start()
    return prof


OUTSIDE = "outside the benchmark's spans"


class _Timeline:
    """Properly nested host spans flattened into disjoint segments, each
    with the innermost span's label (None between spans)."""

    def __init__(self, spans: List[tuple]):
        ev = [(a, 1, lab) for a, _b, lab in spans] + [(b, 0, lab) for _a, b, lab in spans]
        ev.sort(key=lambda e: (e[0], e[1]))
        segs, stack, prev = [], [], None
        for t, start, lab in ev:
            if prev is not None and t > prev:
                segs.append((prev, t, stack[-1] if stack else None))
            if start:
                stack.append(lab)
            else:
                for k in range(len(stack) - 1, -1, -1):
                    if stack[k] == lab:
                        del stack[k]
                        break
            prev = t
        self.segs = segs
        self.starts = [g[0] for g in segs]

    def label(self, t: int) -> str:
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and t < self.segs[i][1] and self.segs[i][2] is not None:
            return self.segs[i][2]
        return OUTSIDE

    def split(self, a: int, b: int, into: dict) -> None:
        """Add the seconds of [a, b) to ``into`` by the label open over
        each part of it."""
        i = max(0, bisect.bisect_right(self.starts, a) - 1)
        covered = 0
        while i < len(self.segs) and self.segs[i][0] < b:
            s0, s1, lab = self.segs[i]
            lo, hi = max(a, s0), min(b, s1)
            if hi > lo:
                into[lab or OUTSIDE] += (hi - lo) * 1e-9
                covered += hi - lo
            i += 1
        if b - a > covered:
            into[OUTSIDE] += (b - a - covered) * 1e-9


def reduce_profile(prof, wall_start: int, wall_end: int,
                   spans: List[tuple]) -> Dict:
    """Busy seconds (union of device intervals inside the window), device
    op totals by name, idle gaps by host span, and device seconds by the
    span that launched them."""
    device, launches = [], {}
    try:
        events = prof.profiler.kineto_results.events()
    except AttributeError:
        events = prof.events()
    for e in events:
        dt = str(e.device_type())
        name = e.name()
        if dt.endswith("CUDA"):
            a = e.start_ns()
            device.append((a, a + e.duration_ns(), name, e.correlation_id()))
        elif name in _LAUNCHES:
            launches[e.correlation_id()] = e.start_ns()
    inside = [d for d in device if d[1] > wall_start and d[0] < wall_end]
    inside.sort()
    busy_ns, gaps = 0, []
    cur_a = cur_b = None
    for a, b, _n, _c in inside:
        a, b = max(a, wall_start), min(b, wall_end)
        if cur_b is None:
            cur_a, cur_b = a, b
            if a > wall_start:
                gaps.append((wall_start, a))
        elif a > cur_b:
            busy_ns += cur_b - cur_a
            gaps.append((cur_b, a))
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        busy_ns += cur_b - cur_a
        if cur_b < wall_end:
            gaps.append((cur_b, wall_end))
    else:
        gaps.append((wall_start, wall_end))
    lookup = _Timeline(spans)
    idle = defaultdict(float)
    for a, b in gaps:
        lookup.split(a, b, idle)
    ops = defaultdict(float)
    by_span = defaultdict(float)
    by_span_n = defaultdict(int)
    attributed = 0
    for a, b, name, corr in inside:
        ops[name[:100]] += (b - a) * 1e-9
        t = launches.get(corr)
        if t is not None:
            attributed += 1
            lab = lookup.label(t)
            by_span[lab] += (b - a) * 1e-9
            by_span_n[lab] += 1
    top = sorted(ops.items(), key=lambda kv: -kv[1])
    return {
        "busy_s": busy_ns * 1e-9,
        "window_s": (wall_end - wall_start) * 1e-9,
        "n_device_ops": len(inside),
        "n_attributed": attributed,
        "device_ops": [[k, v] for k, v in top[:10]],
        "idle_gaps": [[k, v] for k, v in
                      sorted(idle.items(), key=lambda kv: -kv[1])[:10]],
        "by_span": dict(by_span),
        "by_span_n": dict(by_span_n),
    }
