"""Named host spans inside the port's split path, off by default.

``with span("encoder"):`` marks a stretch of host time.  While tracing is
off (the default) :func:`span` hands back one shared object whose
``__enter__`` and ``__exit__`` do nothing: no allocation, no clock read,
no profiler call.  After :func:`enable`, each span appends one record

    (name, t0_ns, t1_ns, parent, request)

to an in-memory list, on ``time.perf_counter_ns()``.  ``parent`` is the
index, in the same list, of the span that was open around it on the same
thread (None at the outermost level) and ``request`` the id the caller
gave the outermost span through :func:`request`; an inner span takes its
parent's.  While a ``torch.profiler`` session is
recording, a span also enters ``record_function(name)``, so that it lands
in the profiler's trace beside the kernels it launched, on the
profiler's clock.

:func:`records` takes the list and clears it; :func:`self_times` gives
each record's time less the part its children cover.  Nothing is written
to a file.

The spans of the MiniConv split path, outermost first:
``split.edge`` (``SplitModel.edge_step_batch``) holds ``encoder``
(``miniconv_apply``), which holds ``encoder.check`` and, on CUDA,
``encoder.prepare`` and ``encoder.launch`` (the K1/K4 wrapper), then
``codec.encode``; ``split.server`` (``SplitModel.server_step_batch``)
holds ``codec.decode`` and ``server.apply``.

The LM split path's (``models.transformer``): ``lm.edge``
(``DecoderModel.edge_forward``) and ``lm.server`` (``server_forward``)
hold, a layer each, ``attn`` (an attention mixer) or ``ssm`` (a Mamba-2
mixer, ``nn.ssm``: ``ssm.proj``, ``ssm.scan``, ``ssm.out``), and ``moe``
(a dropless MoE, ``nn.moe``: ``moe.route``, ``moe.permute``,
``moe.experts`` (K7), ``moe.combine``, ``moe.shared``), or ``mla`` (a
multi-head latent attention mixer, ``nn.mla``: ``mla.q``, ``mla.kv``,
``mla.rope``, ``mla.core`` (K5), ``mla.out``) and ``mlp`` (a dense
layer's FFN).  Under ``SplitModel`` they sit inside ``split.edge`` and
``split.server``.
"""
from __future__ import annotations

import threading
import time

from torch._C._autograd import _profiler_enabled
from torch.autograd.profiler import record_function

_on = False
_records: list = []
_local = threading.local()     # .stack: open spans' records; .request


class _Off:
    """The span handed out while tracing is off: does nothing.  Its
    ``__enter__`` and ``__exit__`` are builtins (``int()`` gives 0,
    ``"".format(et, ev, tb)`` gives "", which lets an exception through),
    so a ``with`` on it runs no Python frame."""

    __slots__ = ()
    __enter__ = int
    __exit__ = "".format


_OFF = _Off()


class _Span:
    __slots__ = ("name", "rec", "rf")

    def __init__(self, name: str):
        self.name, self.rf = name, None

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        parent = stack[-1] if stack else None
        req = parent[4] if parent else getattr(_local, "request", None)
        # [name, t0, t1, parent's record, request]
        self.rec = [self.name, 0, 0, parent, req]
        _records.append(self.rec)
        stack.append(self.rec)
        if _profiler_enabled():
            self.rf = record_function(self.name)
            self.rf.__enter__()
        self.rec[1] = time.perf_counter_ns()
        return self

    def __exit__(self, et, ev, tb):
        self.rec[2] = time.perf_counter_ns()
        if self.rf is not None:
            self.rf.__exit__(et, ev, tb)
        _local.stack.pop()
        return False


def span(name: str):
    """A context manager marking ``name``'s host time (see the module's
    docstring)."""
    if not _on:
        return _OFF
    return _Span(name)


def request(rid) -> None:
    """The request id that this thread's next outermost spans take."""
    _local.request = rid


def enable() -> None:
    """Start recording spans (clears nothing)."""
    global _on
    _on = True


def disable() -> None:
    """Stop recording spans; the records stay until :func:`records`."""
    global _on
    _on = False


def records() -> list:
    """Take the records kept so far, as (name, t0_ns, t1_ns, parent,
    request) tuples in the order the spans opened, and clear them.  A
    span still open has ``t1_ns`` 0; one whose parent was taken by an
    earlier call has ``parent`` None."""
    global _records
    out, _records = _records, []
    index = {id(r): i for i, r in enumerate(out)}
    return [(r[0], r[1], r[2],
             None if r[3] is None else index.get(id(r[3])), r[4])
            for r in out]


def self_times(recs) -> list:
    """Each record's duration in ns less the durations of its children
    (records whose ``parent`` is its index), in the records' order."""
    out = [r[2] - r[1] for r in recs]
    for r in recs:
        if r[3] is not None:
            out[r[3]] -= r[2] - r[1]
    return out


__all__ = ["disable", "enable", "records", "request",
           "self_times", "span"]
