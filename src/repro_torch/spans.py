"""The program's host spans: named intervals of the host's time that
``torch.profiler`` records, on the thread that opens them, as events named
``thinkv.<name>`` (the benchmark's profiled slice keeps every event with
that prefix, on the clock of the device's operations).

A span is a ``RecordFunction`` (``torch._C._profiler._RecordFunctionFast``
where the build has it, ``torch.profiler.record_function`` elsewhere):
with the profiler off it costs the host well under a microsecond, and it
changes nothing the program computes.

The spans, each inside the one above it (``PERF.md`` §3 names what reads
each):

* ``tick`` (``serving/engine.py::_trip``): one decode tick and its draw;
  inside it ``trunk`` (embedding, qkv, buffer writes and FFN of every
  layer; MoE layers add ``route`` and ``experts``), ``attend`` (the fused
  attention and a refresh tick's sparsity), ``project`` (the attention
  output residuals), ``advance`` (the active slots' cache maintenance)
  and ``logits`` (final norm, unembedding, softcap and the draw);
* ``prefill`` (``ThinKVEngine.prefill``): a prompt's chunked prefill and
  its first token;
* ``maintain`` (``core/ct_cache.py::engine_advance``, inside ``advance``
  or ``prefill``): a slot's due commit and refresh; inside it ``commit``
  (``commit_group``), ``evict`` (``budget_evict``; each anneal round is an
  ``anneal``), ``refresh`` (its own ``anneal`` and ``evict`` spans) and
  ``tables`` (the COW compare and ``sync_block_tables``); what lies in
  ``maintain`` outside all four is ``gather_view``;
* ``deliver`` (``serving/orchestrator.py``): a tick's tokens fanned out to
  their requests' streams;
* ``readback``, anywhere: one statement at which the host waits for the
  device — a read to the host (``.cpu()``, ``.tolist()``, ``int`` /
  ``bool`` of a tensor), a shape that depends on the data (a boolean-mask
  index), or a synchronous upload from pageable memory (on the card each
  of these synchronizes the stream).  The tick's result is copied to the
  host on an executor thread, which the profiler does not record; its
  ``readback`` span is opened on the serving thread around the wait for
  that copy (``Orchestrator.serve``).
"""
from __future__ import annotations

import functools

import torch

PREFIX = "thinkv."
_FAST = getattr(torch._C._profiler, "_RecordFunctionFast", None)


def span(name: str):
    """The context manager of the span ``thinkv.<name>``."""
    if _FAST is not None:
        return _FAST(PREFIX + name)
    return torch.profiler.record_function(PREFIX + name)


def readback():
    """The span of one statement at which the host waits for the device
    (see the module docstring)."""
    return span("readback")


def traced(name: str):
    """Decorate a function so that each of its calls is the span
    ``thinkv.<name>``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap
