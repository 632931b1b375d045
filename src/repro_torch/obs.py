"""An in-memory flight recorder of host spans.

``span(name, **attrs)`` is a context manager that times one interval of
host work on ``time.monotonic()``: the clock that a benchmark's records,
its own spans and its profiler window use, so the program's spans and the
card's activity share one timeline. A span's parent is the innermost span
open on the same thread (a ``contextvars`` stack, so threads never mix)
and its ``root`` the outermost: the spans of one replica start share the
id of their ``engine.start``, and the spans of one request its ``rid``.

Records go into a bounded ``deque`` (``CAPACITY``) as plain tuples, which
the garbage collector stops tracking, so a full buffer adds nothing to a
full collection's walk; ``dropped`` counts what fell off its old end. The
recorder is on by default and costs a few microseconds a span (two clock
reads, the context variable, one append); ``set_enabled(False)`` stops
recording, but a span still times itself, so the counters that read its
``dur`` (``LoadStats``, ``ServeStats``) stay filled. It adds no
synchronisation and emits nothing into ``torch.profiler``: a span ends
where the code it wraps already waits for the device, or measures only the
host's issue.

The read side is ``spans()``, ``clear()`` and ``dropped()``. Each record
unpacks as ``(name, t0, t1)``, the form ``bench/trace.py``'s ``summary``
takes, with ``id``, ``parent``, ``root`` and ``attrs`` beside it.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from contextvars import ContextVar

CAPACITY = 1 << 16

_now = time.monotonic
_ids = itertools.count(1)
_records: deque = deque(maxlen=CAPACITY)
_open: ContextVar = ContextVar("repro_torch_obs_open", default=None)
_state = {"enabled": True, "dropped": 0}
_lock = threading.Lock()        # the drop count and the append, together


class Span:
    """One timed interval; ``keep = False`` before it closes leaves it out
    of the record (an idle turn of a loop)."""

    __slots__ = ("id", "parent", "root", "name", "t0", "t1", "attrs", "keep", "_token")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs
        self.keep = True
        self.t0 = self.t1 = 0.0

    def __enter__(self) -> "Span":
        up = _open.get()
        self.id = next(_ids)
        self.parent = None if up is None else up.id
        self.root = self.id if up is None else up.root
        self._token = _open.set(self)
        self.t0 = _now()
        return self

    def __exit__(self, *exc) -> None:
        self.t1 = _now()
        _open.reset(self._token)
        if self.keep:
            _append(self)

    @classmethod
    def _of(cls, rec: tuple) -> "Span":
        s = cls.__new__(cls)
        s.id, s.parent, s.root, s.name, s.t0, s.t1, attrs = rec
        s.attrs = dict(attrs)
        s.keep = True
        return s

    def __iter__(self):
        return iter((self.name, self.t0, self.t1))

    @property
    def dur(self) -> float:
        return self.t1 - self.t0

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, "
                f"t0={self.t0:.6f}, dur={self.dur:.6f}, attrs={self.attrs})")


def _append(s: Span) -> None:
    if _state["enabled"]:
        # attrs as item pairs: a tuple holding a dict stays tracked
        rec = (s.id, s.parent, s.root, s.name, s.t0, s.t1, tuple(s.attrs.items()))
        with _lock:
            if len(_records) == _records.maxlen:
                _state["dropped"] += 1
            _records.append(rec)


def span(name: str, **attrs) -> Span:
    """A span to open with ``with``; ``attrs`` may be added to while open."""
    return Span(name, attrs)


def interval(name: str, t0: float, t1: float, **attrs) -> Span:
    """Record an interval that no single block of code encloses (a request
    waiting across turns of a loop), stamped by the caller on
    ``time.monotonic()``; it has no parent."""
    s = Span(name, attrs)
    s.id, s.parent, s.t0, s.t1 = next(_ids), None, t0, t1
    s.root = s.id
    _append(s)
    return s


def spans() -> list:
    """The kept records as ``Span``s, oldest first (in the order they
    closed)."""
    with _lock:
        kept = list(_records)
    return [Span._of(r) for r in kept]


def dropped() -> int:
    """Records pushed off the buffer's old end since the last ``clear``."""
    return _state["dropped"]


def clear() -> None:
    with _lock:
        _records.clear()
        _state["dropped"] = 0


def set_enabled(on: bool) -> None:
    _state["enabled"] = bool(on)
