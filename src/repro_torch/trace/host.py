"""Host spans on wall time, for the port's functional plane.

The simulator's :class:`~repro_torch.trace.tracer.Tracer` records intervals
on simulated nanoseconds.  The functional plane (the checkpoint manager, the
storage cluster's packet plane, the erasure layer and its copies to and from
the device) runs on the host's clock, partly on threads the program starts
itself.  This module records that plane into the same kind of buffer:

* :data:`TRACER` — a :class:`HostTracer`, the simulator's bounded buffer
  (``max_spans``; past the bound spans are counted in ``dropped``) holding
  :class:`HostSpan`\\ s, which add a span id (``sid``) and the id of the span
  that caused it (``parent``) to :class:`Span`;
* :func:`span` — ``with span(name, **counts) as s:`` around a piece of work;
  ``s.set(**counts)`` adds counts known only at its end.

Fields of a host span: ``t0``/``t1`` from :func:`time.time_ns` (the clock of
``torch.profiler``'s host events once a Chrome trace's
``baseTimeNanoseconds`` is added to their ``ts``), ``resource`` the thread's
track (``host.<thread name>``), ``node`` the thread's ident, ``cat``
``"host"``, or ``"wait"`` for a span that only blocks on another thread,
``rid`` the request it serves (the checkpoint step), inherited from the span
it nests in, and ``args`` its counts.  The parent comes from a thread-local
stack; a thread's root span takes an explicit ``parent`` (the checkpoint
writer's ``ckpt.write`` takes its ``ckpt.save``).

Recording is on while a ``torch.profiler`` session is active anywhere in the
process (``torch.autograd.profiler._is_profiler_enabled``, a module flag that
every thread sees, unlike the profiler's own per-thread state), or after
:func:`enable`.  Off, a span site costs that flag check and returns a shared
no-op.  Nothing here counts per packet: a request's packet count rides on its
span as an argument.

An operator traces a run by hand::

    from repro_torch.trace import host, write_chrome_trace
    host.enable()
    ...                                 # saves and restores
    host.enable(False)
    write_chrome_trace(host.TRACER, "host_spans.json")
"""

from __future__ import annotations

import itertools
import threading
import time

import torch.autograd.profiler as _autograd_profiler

from .tracer import Span, Tracer

#: span categories: work, and a wait on another thread's work
HOST, WAIT = "host", "wait"


class HostSpan(Span):
    """A :class:`Span` with its own id and the id of the span that caused it."""

    __slots__ = ("sid", "parent")

    def __init__(self, name, cat, t0, t1, rid=None, pid=None, node=None,
                 resource=None, args=None, sid=None, parent=None):
        self.name, self.cat, self.t0, self.t1 = name, cat, t0, t1
        self.rid, self.pid, self.node, self.resource, self.args = rid, pid, node, resource, args
        self.sid, self.parent = sid, parent


class HostTracer(Tracer):
    """The bounded buffer of host spans; threads record into it at once."""

    def __init__(self, max_spans: int = 1 << 18):
        super().__init__(sample_every=1, max_spans=max_spans)
        self._lock = threading.Lock()

    def add(self, sp: HostSpan) -> HostSpan | None:
        """Keep ``sp``; past ``max_spans`` count it in ``dropped`` instead."""
        with self._lock:
            if len(self.spans) >= self.max_spans:
                self.dropped += 1
                return None
            self.spans.append(sp)
            return sp


TRACER = HostTracer()
_enabled = False
_ids = itertools.count(1)
_local = threading.local()


def enable(on: bool = True) -> None:
    """Record host spans whether or not a profiler runs (``False``: only
    while one runs)."""
    global _enabled
    _enabled = bool(on)


class _Off:
    """What :func:`span` returns while recording is off: does nothing."""

    __slots__ = ()
    sid = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __bool__(self):
        return False

    def set(self, **counts) -> None:
        pass


_OFF = _Off()


class _Thread:
    """A thread's open spans and its track."""

    __slots__ = ("stack", "ident", "track")

    def __init__(self):
        thread = threading.current_thread()
        self.stack: list[_Open] = []
        self.ident, self.track = thread.ident, f"host.{thread.name}"


class _Open:
    """One span being recorded on the calling thread."""

    __slots__ = ("name", "cat", "rid", "parent", "args", "sid", "t0", "thread")

    def __init__(self, name, cat, rid, parent, args):
        self.name, self.cat, self.rid, self.parent, self.args = name, cat, rid, parent, args

    def __enter__(self):
        thread = getattr(_local, "thread", None)
        if thread is None:
            thread = _local.thread = _Thread()
        if thread.stack:
            outer = thread.stack[-1]
            if self.parent is None:
                self.parent = outer.sid
            if self.rid is None:
                self.rid = outer.rid
        self.sid = next(_ids)
        self.thread = thread
        thread.stack.append(self)
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        thread = self.thread
        thread.stack.pop()
        TRACER.add(HostSpan(self.name, self.cat, self.t0, t1, self.rid, None, thread.ident,
                            thread.track, self.args or None, self.sid, self.parent))
        return False

    def __bool__(self):
        return True

    def set(self, **counts) -> None:
        self.args.update(counts)


def span(name: str, *, rid=None, parent=None, wait: bool = False, **counts):
    """A context manager that records ``name`` over its block while
    recording is on (a shared no-op, false in a boolean test, while off)."""
    if not (_enabled or _autograd_profiler._is_profiler_enabled):
        return _OFF
    return _Open(name, WAIT if wait else HOST, rid, parent, counts)
