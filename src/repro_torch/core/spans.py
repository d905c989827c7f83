"""Timing of the port's drivers: host-clock spans and host counters.

``span(name, host=False, **attrs)`` is a context manager whose object
carries its host duration ``seconds`` (``time.perf_counter``) once it
closes; the drivers fill their stats from it (``PassStats``,
``BatchUpdateStats``).  ``host=True`` marks work the card does not share
(NumPy work, copies to the host).  ``count(name, n)`` adds ``n`` to a host
counter; it is only handed values already on the host.

Recording is on while a ``torch.profiler`` session runs or inside
``recording()``.  Then each span also enters
``torch.profiler.record_function("repro_torch." + name)``, so it lies in
the profiler's trace on the device trace's clock, and is stored with its
Unix-epoch bounds (``time.time_ns``, the clock of the profiler's host
events), its parent, its request (the index of its outermost span, which
its children share) and its attributes.  ``session()`` returns what was
stored since recording last switched on; the store is cleared at the first
span or count of a new recording.  When recording is off, a span costs a
flag check and its two ``perf_counter`` reads, and nothing is stored.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, NamedTuple, Optional

import torch

#: Prefix of the spans' names in the profiler's trace.
PREFIX = "repro_torch."

_spans: List["span"] = []
_counters: Dict[str, int] = {}
_forced = 0            # depth of open ``recording()`` blocks
_was_on = False        # recording as last observed
_open: List["span"] = []   # the stored spans open now, innermost last


def _recording() -> bool:
    """Whether recording is on; clears the store when it just turned on."""
    global _was_on
    on = _forced > 0 or torch.autograd._profiler_enabled()
    if on and not _was_on:
        _spans.clear()
        _counters.clear()
        _open.clear()
    _was_on = on
    return on


class span:
    """A timed region; ``seconds`` is its host duration once it closes.
    Stored while recording: ``name``, ``start_ns``/``end_ns`` (Unix
    epoch), ``parent`` (the index of the enclosing stored span, -1 for
    none), ``request`` (the index of the outermost one), ``attrs``,
    ``host`` and ``index`` (its place in ``session().spans``)."""

    __slots__ = ("name", "host", "attrs", "seconds", "start_ns", "end_ns",
                 "parent", "request", "index", "_t0", "_rf")

    def __init__(self, name: str, host: bool = False, **attrs):
        self.name, self.host, self.attrs = name, host, attrs
        self.seconds: Optional[float] = None
        self._rf = None

    def __enter__(self) -> "span":
        if _recording():
            self.start_ns = time.time_ns()
            self._rf = torch.profiler.record_function(PREFIX + self.name)
            self._rf.__enter__()
            outer = _open[-1] if _open else None
            self.index = len(_spans)
            self.parent = outer.index if outer is not None else -1
            self.request = outer.request if outer is not None else self.index
            _spans.append(self)
            _open.append(self)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self.seconds = time.perf_counter() - self._t0
        if self._rf is not None:
            self.end_ns = time.time_ns()
            if _open and _open[-1] is self:
                _open.pop()
            self._rf.__exit__(*exc)
            self._rf = None
        return False


def count(name: str, n: int = 1) -> None:
    """Add ``n`` (a host int) to the counter ``name`` while recording."""
    if _recording():
        _counters[name] = _counters.get(name, 0) + n


@contextlib.contextmanager
def recording():
    """Record spans and counters inside the block, with or without a
    profiler (a new recording starts when none was on)."""
    global _forced
    _recording()
    _forced += 1
    _recording()
    try:
        yield
    finally:
        _forced -= 1
        _recording()


class Session(NamedTuple):
    """What was recorded: the spans in the order they opened, and the
    counters."""

    spans: List[span]
    counters: Dict[str, int]

    def requests(self) -> Dict[int, List[span]]:
        """The spans of each request (keyed by its root's index), in the
        order they opened; the root first."""
        out: Dict[int, List[span]] = {}
        for s in self.spans:
            out.setdefault(s.request, []).append(s)
        return out

    def matching(self, name: str, seconds) -> Optional[List[span]]:
        """For each duration in ``seconds``, a span named ``name`` that
        lasted exactly that long, each span taken once, in the given order;
        None when one is missing.  A stat filled from a span
        (``total_seconds``, ``apply_seconds``) finds its span so."""
        pool: Dict[float, List[span]] = {}
        for s in self.spans:
            if s.name == name:
                pool.setdefault(s.seconds, []).append(s)
        out = []
        for sec in seconds:
            found = pool.get(sec)
            if not found:
                return None
            out.append(found.pop(0))
        return out

    def enclosing(self, s: span, name: str) -> Optional[span]:
        """The innermost span named ``name`` that encloses ``s`` (``s``
        itself included), or None."""
        while s is not None and s.name != name:
            s = self.spans[s.parent] if s.parent >= 0 else None
        return s


def session() -> Session:
    """The spans and counters recorded since recording last switched on."""
    return Session(list(_spans), dict(_counters))
