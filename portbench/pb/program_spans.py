"""The program's own host spans (``repro_torch.tracing``) inside a traced
run's window, for the per-layer readers that read them.

The program records its spans while the profiler of a traced run
(``--trace 1``) is recording, into a buffer of its own, on the clock the
benchmark's spans (``run.spans``) are stamped with.  The window is the
extent of the benchmark's spans; a program span belongs to it if it
opened inside it, so spans an earlier run left in the process are not
read.  Each span is ``(name, start_ns, end_ns, parent)``, ``parent`` the
index of the span open around it.

:func:`ms_per_step` returns ``None`` when there is nothing sound to
read: a program without the tracer, a window with no decode step, or a
window in which the tracer's full buffer dropped a span.
"""

from __future__ import annotations

from typing import Optional

DECODE_STEP = "serve.decode_step"


def ms_per_step(run, name: str) -> Optional[float]:
    """Host milliseconds of the spans called ``name`` inside the window's
    decode steps (the steps themselves for ``DECODE_STEP``), over the
    steps."""
    try:
        from repro_torch import tracing
    except ImportError:                 # a program without its own spans
        return None
    if not run.spans:
        return None
    lo = min(s[0] for s in run.spans)
    hi = max(s[1] for s in run.spans)
    if tracing.dropped and tracing.dropped_ns >= lo:
        return None
    buf = tracing.spans()
    steps = {i for i, s in enumerate(buf)
             if s[0] == DECODE_STEP and lo <= s[1] <= hi}
    if not steps:
        return None
    total = 0
    for i, s in enumerate(buf):
        if s[0] != name:
            continue
        step = i
        while step >= 0 and buf[step][0] != DECODE_STEP:
            step = buf[step][3]
        if step in steps:
            total += s[2] - s[1]
    return 1e-6 * total / len(steps)
