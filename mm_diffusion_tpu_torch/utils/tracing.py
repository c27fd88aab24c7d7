"""Spans: named host ranges at the port's layer boundaries (a sampler call,
each model evaluation, the parts of a train step), recorded only when a
reader asks for them.

Off by default.  :func:`span` then returns one shared no-op context: its
whole cost is the check of a module flag, and it records nothing and opens
no profiler range.  Between :func:`enable` and :func:`disable` each span

* opens a ``torch.profiler.record_function`` range, so that inside a
  profiler window the span is a user annotation in the same trace, on the
  same clock, as the kernels and the CUDA runtime calls that it launched;
* appends a :class:`Span` (host times from ``time.perf_counter_ns``) to a
  ring of :data:`CAPACITY` records, which drops the oldest when full.
  :func:`drain` returns the records in the order the spans were opened and
  empties the ring.

A span's ``id`` is the request it serves (a sampler call's number, a train
step's ``state.step``); left out, it is the enclosing span's.  Spans nest
per thread.

    from mm_diffusion_tpu_torch.utils import tracing
    tracing.enable()
    ...  # sampler calls, train steps
    tracing.disable()
    for s in tracing.drain():
        print(s.name, s.id, (s.end_ns - s.start_ns) / 1e6, "ms")
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import List, NamedTuple, Optional

import torch

CAPACITY = 1 << 16  # records the ring holds


class Span(NamedTuple):
    name: str
    id: Optional[int]
    parent: int  # index in the drained list of the span open around it; -1: none, or dropped
    start_ns: int
    end_ns: int


_NULL = contextlib.nullcontext()
_on = False
_ring: collections.deque = collections.deque(maxlen=CAPACITY)
_serials = itertools.count()
_local = threading.local()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Open:
    """One recording span: a profiler range and, when it closes, a record."""

    __slots__ = ("name", "id", "serial", "parent", "start", "range")

    def __init__(self, name: str, id: Optional[int]):
        self.name, self.id = name, id

    def __enter__(self):
        stack = _stack()
        outer = stack[-1] if stack else None
        if self.id is None and outer is not None:
            self.id = outer.id
        self.parent = -1 if outer is None else outer.serial
        self.serial = next(_serials)
        stack.append(self)
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        self.range.__exit__(*exc)
        _stack().pop()
        _ring.append((self.serial, self.name, self.id, self.parent, self.start, end))
        return False


def span(name: str, id: Optional[int] = None):
    """A context that records the block as span ``name`` of request ``id``
    while tracing is on, and does nothing while it is off."""
    if not _on:
        return _NULL
    return _Open(name, id)


def enable() -> None:
    """Record spans from now on, into an empty ring."""
    global _on, _ring
    _ring = collections.deque(maxlen=CAPACITY)
    _on = True


def disable() -> None:
    """Stop recording; the ring keeps what was recorded for :func:`drain`."""
    global _on
    _on = False


def drain() -> List[Span]:
    """The recorded spans in the order they were opened; empties the ring."""
    taken = sorted(_ring)  # by serial
    _ring.clear()
    index = {rec[0]: i for i, rec in enumerate(taken)}
    return [Span(name, id, index.get(parent, -1), start, end)
            for _, name, id, parent, start, end in taken]
