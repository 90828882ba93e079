"""The port's one tracer: program spans and counters, kept in memory.

* `span(name)` is a context manager (and a decorator) that records
  (id, name, start ns, end ns, parent id, root id, counts) into a bounded
  ring, on `time.time_ns()`, the clock of a torch.profiler trace's events.
  Only while a torch.profiler is recording does a span also enter
  `record_function(name)`, so a device trace shows the same ranges; else
  it costs two clock reads and an append.  `span(name, ranged=False)` is
  never a range: an entry point's span over a whole walk or request,
  which a CUDA trace would otherwise show as one device annotation as
  long as the walk.
* The outermost span open on a thread is a root (one walk, one request):
  every span under it carries its id.  Each root notes whether a profiler
  was recording during it.
* `count(name, n)` adds to a process-wide counter and to the innermost open
  span's counts.  The kernel wrappers count their launches and their
  `KernelError`s this way, always.
* A root is armed by `enable()` / `tracing()`, or by itself when it starts
  while a profiler is recording.  Armed, its spans also count
  `cuda.syncs` (every synchronising CUDA operation, through
  `torch.cuda.set_sync_debug_mode("warn")`; each one's time and Python call
  site kept in `snapshot()["syncs"]`) and `cuda.mallocs`, `cuda.frees`,
  `cuda.alloc_retries` (the caching allocator's device calls, read at each
  span boundary).  The sync debug mode and the warning filter are set for
  the armed roots and restored after them.
* `snapshot()` returns all of it as a JSON-able dict, `reset()` clears it.

The module's functions act on one process-wide `Tracer`; a `Tracer` of its
own (a smaller ring, say) works the same way.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import json
import os
import sys
import threading
import time
import warnings

import torch

CAPACITY = 1 << 15  # spans: a 30 s window of ~350 random batches x 27
ROOT_CAPACITY = 1 << 12
SYNC_MESSAGE = "called a synchronizing CUDA operation"
# what torch says once when the sync debug mode is first set
PROTOTYPE_MESSAGE = "Synchronization debug mode is a prototype"
FIELDS = ("id", "name", "start_ns", "end_ns", "parent", "root", "counts")
# the caching allocator's statistics -> counter names
ALLOCATOR = (("num_device_alloc", "cuda.mallocs"),
             ("num_device_free", "cuda.frees"),
             ("num_alloc_retries", "cuda.alloc_retries"))
_SKIPPED = (os.path.dirname(torch.__file__) + os.sep, warnings.__file__,
            __file__)
_PACKAGE_PARENT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


class _Open:
    """A span while it is open."""

    __slots__ = ("id", "name", "parent", "root", "armed", "profiled",
                 "attrs", "counts", "rf", "start")

    def __init__(self, sid, name, parent, root, armed, profiled, attrs):
        self.id, self.name, self.parent, self.root = sid, name, parent, root
        self.armed, self.profiled, self.attrs = armed, profiled, attrs
        self.counts = self.rf = None


def _allocator_calls():
    """(device allocs, frees, retries) of the current card so far, or None
    before CUDA is initialised."""
    if not torch.cuda.is_initialized():
        return None
    stats = torch.cuda.memory_stats_as_nested_dict()
    return tuple(stats.get(key, 0) for key, _ in ALLOCATOR)


def _outside(frame) -> tuple:
    """(file, line) of the innermost frame from `frame` out that lies
    outside torch, the warnings module and this file."""
    while frame is not None and frame.f_code.co_filename.startswith(_SKIPPED):
        frame = frame.f_back
    return (frame.f_code.co_filename, frame.f_lineno) if frame else ("?", 0)


def _site(filename: str, lineno: int) -> str:
    """file:line, relative to this checkout where it lies inside it."""
    if filename.startswith(_PACKAGE_PARENT + os.sep):
        filename = filename[len(_PACKAGE_PARENT) + 1:]
    return f"{filename}:{lineno}"


class _Span:
    """`Tracer.span(name)`: holds no state of its own, so one object may be
    entered again, nested or on another thread, and decorate a function."""

    __slots__ = ("tracer", "name", "ranged", "attrs")

    def __init__(self, tracer, name, ranged, attrs):
        self.tracer, self.name = tracer, name
        self.ranged, self.attrs = ranged, attrs

    def __enter__(self):
        self.tracer._enter(self.name, self.ranged, self.attrs)
        return self

    def __exit__(self, *exc):
        self.tracer._exit()
        return False

    def __call__(self, fn):
        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with self:
                return fn(*args, **kwargs)
        return spanned


class Tracer:
    """Spans in a ring of `capacity` (the oldest dropped first), the roots
    in one of `root_capacity`, counters, and the armed roots' syncs."""

    def __init__(self, capacity: int = CAPACITY,
                 root_capacity: int = ROOT_CAPACITY):
        self.capacity, self.root_capacity = capacity, root_capacity
        self._local = threading.local()
        self._ids = itertools.count(1)
        self._lock = threading.Lock()  # arming, counters
        self._armed_roots = 0
        self._restore = None
        self.enabled = False
        self.reset()

    # -- spans ---------------------------------------------------------
    def span(self, name: str, ranged: bool = True, **attrs) -> _Span:
        """A span named `name`, a range of a profiler trace while one
        records unless not `ranged`; a root keeps `attrs` in its record."""
        return _Span(self, name, ranged, attrs)

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _enter(self, name, ranged, attrs):
        stack = self._stack()
        profiled = torch.autograd._profiler_enabled()
        if stack:
            top = stack[-1]
            fr = _Open(next(self._ids), name, top.id, top.root, top.armed,
                       profiled, None)
            if top.armed:
                self._allocator_mark()
        else:
            sid = next(self._ids)
            fr = _Open(sid, name, None, sid, self.enabled or profiled,
                       profiled, attrs)
            if fr.armed:
                self._arm()
                self._local.allocator = _allocator_calls()
        stack.append(fr)
        if profiled and ranged:
            fr.rf = torch.autograd.profiler.record_function(name)
        fr.start = time.time_ns()
        if fr.rf is not None:
            fr.rf.__enter__()

    def _exit(self):
        stack = self._stack()
        fr = stack[-1]
        if fr.rf is not None:
            fr.rf.__exit__(None, None, None)
        end = time.time_ns()
        if fr.armed:
            self._allocator_mark()
        stack.pop()
        self._spans.append((fr.id, fr.name, fr.start, end, fr.parent,
                            fr.root, fr.counts))
        self._n_spans += 1
        if fr.parent is None:
            if fr.armed:
                self._disarm()
            self._roots.append(dict(
                id=fr.id, name=fr.name, start_ns=fr.start, end_ns=end,
                profiled=fr.profiled or torch.autograd._profiler_enabled(),
                armed=fr.armed, **fr.attrs))

    def current_root(self):
        """The id of this thread's open root, or None."""
        stack = self._stack()
        return stack[0].id if stack else None

    # -- counters ------------------------------------------------------
    def count(self, name: str, n: int = 1):
        """Add n to counter `name`, process-wide and in the innermost span
        open on this thread."""
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n
        stack = getattr(self._local, "stack", None)
        if stack:
            fr = stack[-1]
            if fr.counts is None:
                fr.counts = {}
            fr.counts[name] = fr.counts.get(name, 0) + n

    def counters(self) -> dict:
        with self._lock:
            return dict(self._counters)

    def _allocator_mark(self):
        """The allocator's calls since this thread's last mark, counted to
        its innermost open span."""
        now = _allocator_calls()
        last, self._local.allocator = getattr(self._local, "allocator",
                                              None), now
        if now is None or last is None:
            return
        for (_, name), a, b in zip(ALLOCATOR, now, last):
            if a != b:
                self.count(name, a - b)

    # -- arming --------------------------------------------------------
    def _arm(self):
        with self._lock:
            self._armed_roots += 1
            if self._armed_roots > 1:
                return
            caught = warnings.catch_warnings()
            caught.__enter__()
            shown = warnings.showwarning
            warnings.filterwarnings("ignore", message=PROTOTYPE_MESSAGE)
            warnings.filterwarnings("always", message=SYNC_MESSAGE)
            warnings.showwarning = functools.partial(self._warned, shown)
            mode = None
            if torch.cuda.is_initialized():
                mode = torch.cuda.get_sync_debug_mode()
                torch.cuda.set_sync_debug_mode("warn")
            self._restore = (caught, mode)

    def _disarm(self):
        with self._lock:
            self._armed_roots -= 1
            if self._armed_roots:
                return
            caught, mode = self._restore
            self._restore = None
            if mode is not None:
                torch.cuda.set_sync_debug_mode(mode)
            caught.__exit__(None, None, None)

    def _warned(self, shown, message, category, filename, lineno, file=None,
                line=None):
        if not str(message).startswith(SYNC_MESSAGE):
            shown(message, category, filename, lineno, file, line)
            return
        now = time.time_ns()
        if filename.startswith(_SKIPPED):  # raised inside torch's Python
            filename, lineno = _outside(sys._getframe(1))
        self.count("cuda.syncs")
        stack = getattr(self._local, "stack", None)
        fr = stack[-1] if stack else None
        self._syncs.append((now, filename, lineno, fr and fr.id,
                            fr and fr.root))

    def enable(self, on: bool = True):
        """Arm every root that starts from now on (or, with False, only
        those that start while a profiler is recording)."""
        self.enabled = bool(on)

    @contextlib.contextmanager
    def tracing(self):
        """Arm the roots that start inside the block."""
        was, self.enabled = self.enabled, True
        try:
            yield self
        finally:
            self.enabled = was

    # -- what was recorded ---------------------------------------------
    def snapshot(self) -> dict:
        """The ring, the roots, the counters and the armed roots' syncs
        (time ns, call site, span id, root id) as a JSON-able dict."""
        spans = list(self._spans)
        return {"clock": "time.time_ns", "capacity": self.capacity,
                "fields": list(FIELDS),
                "dropped": self._n_spans - len(spans),
                "spans": [list(s) for s in spans],
                "roots": list(self._roots),
                "counters": self.counters(),
                "syncs": [[t, _site(f, line), sid, rid]
                          for t, f, line, sid, rid in list(self._syncs)]}

    def write(self, path: str):
        """The snapshot as a JSON file."""
        with open(path, "w") as f:
            json.dump(self.snapshot(), f)

    def reset(self, prefix: str | None = None):
        """Clear the ring, the roots, the syncs and the counters; with a
        prefix only the counters whose names start with it."""
        with self._lock:
            if prefix is not None:
                self._counters = {k: v for k, v in self._counters.items()
                                  if not k.startswith(prefix)}
                return
            self._counters = {}
        self._spans = collections.deque(maxlen=self.capacity)
        self._roots = collections.deque(maxlen=self.root_capacity)
        self._syncs = collections.deque(maxlen=self.capacity)
        self._n_spans = 0


TRACER = Tracer()
span = TRACER.span
count = TRACER.count
counters = TRACER.counters
current_root = TRACER.current_root
enable = TRACER.enable
tracing = TRACER.tracing
snapshot = TRACER.snapshot
write = TRACER.write
reset = TRACER.reset
