"""Host spans of the port, on the profiler's clock, off unless asked for.

    from repro_torch import tracing

    with tracing.span("layer.moe"):
        ...

A span is recorded only while a torch profiler is recording, or inside
:func:`recording` (tests, an operator's own reading).  Otherwise
:func:`span` tests the flags and returns one shared null context: it reads
no clock, allocates nothing and opens no profiler range.

A recorded span stamps ``time.time_ns()`` (the wall clock the profiler's
events are stamped with) before it opens a profiler range of its name and
again after it closes it, so the range lies inside the span's interval and
the profiler's trace nests the ops and launches the span issued under the
span's name.  The range is the profiler's plain CPU range
(``_RecordFunctionFast``), not ``record_function``'s: with device activity
on, the profiler mirrors a ``record_function`` range onto the device's
timeline as a user annotation that stretches from its first kernel to its
last, idle time included, and a reading of device busy time or device ops
would count it as work.

The buffer (:func:`spans`) holds the spans in the order they opened, each
``(name, start_ns, end_ns, parent)``: ``parent`` is the index in the buffer
of the span open around it on the same thread (-1 for none), and
``end_ns`` is 0 while the span is open.  It holds at most
:data:`CAPACITY` spans; a span opened when it is full is dropped and
counted in :data:`dropped`, and :data:`dropped_ns` is the clock at the
latest drop.  :func:`reset` empties it, with no span open.

The spans of the serving path (the benchmark's per-layer readers cite
these names):

``serve.request``, ``serve.tier``, ``serve.prefill``, ``serve.clone``,
``serve.decode_step`` (``launch.serve.serve``); ``model.embed``,
``model.head`` (``models.transformer.forward``); ``layer.attn`` with
``attn.qkv``, ``attn.cache_write``, ``attn.kernel``, ``attn.out``
(``models.layers.apply_attn``); ``layer.moe`` with ``moe.route``,
``moe.dispatch``, ``moe.experts``, ``moe.combine``, ``moe.shared``,
``moe.aux`` (``models.layers.apply_moe``).
"""

from __future__ import annotations

import contextlib
import threading
import time
from array import array
from typing import Iterator, List, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler

#: Spans the buffer holds; a traced 30 s window of the served MoE model
#: opens ~60,000.
CAPACITY = 1 << 18
#: Spans opened while the buffer was full.
dropped = 0
#: ``time.time_ns()`` at the latest drop (0: none since the last reset).
dropped_ns = 0

# The buffer, one entry a span in the order they opened: plain arrays, so
# that a long window adds no object the garbage collector walks.
_names: List[str] = []
_starts = array("q")
_ends = array("q")
_parents = array("q")
_lock = threading.Lock()
_open = threading.local()
#: Depth of :func:`recording` contexts.
_recording = 0
_NULL = contextlib.nullcontext()
_RANGE = torch._C._profiler._RecordFunctionFast


def _profiling() -> bool:
    """Whether a torch profiler is recording (the flag its start sets)."""
    return _autograd_profiler._is_profiler_enabled


class _Span:
    __slots__ = ("name", "index", "stack", "range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        global dropped, dropped_ns
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        t0 = time.time_ns()
        with _lock:
            index = len(_names)
            if index < CAPACITY:
                _names.append(self.name)
                _starts.append(t0)
                _ends.append(0)
                _parents.append(stack[-1] if stack else -1)
                stack.append(index)
            else:
                index = -1
                dropped += 1
                dropped_ns = t0
        self.index = index
        self.stack = stack
        self.range = _RANGE(self.name)
        self.range.__enter__()
        return self

    def __exit__(self, *exc):
        self.range.__exit__(*exc)
        if self.index >= 0:
            _ends[self.index] = time.time_ns()
            self.stack.pop()
        return False


def span(name: str):
    """A context that records the host's interval under ``name`` while
    tracing is on, and does nothing otherwise."""
    if _recording or _profiling():
        return _Span(name)
    return _NULL


@contextlib.contextmanager
def recording() -> Iterator[None]:
    """Record spans inside this context, with or without a profiler."""
    global _recording
    _recording += 1
    try:
        yield
    finally:
        _recording -= 1


def spans() -> List[Tuple[str, int, int, int]]:
    """The buffer: ``(name, start_ns, end_ns, parent)`` a span, in the order
    they opened."""
    return list(zip(_names, _starts, _ends, _parents))


def reset() -> None:
    """Empty the buffer and zero :data:`dropped`; call with no span open."""
    global dropped, dropped_ns
    with _lock:
        del _names[:], _starts[:], _ends[:], _parents[:]
        dropped = 0
        dropped_ns = 0
