"""Tracing of the port: spans inside the program, and a device trace that
places them.

``span(name, device=False)`` marks a stretch of host code. It records only
while a ``torch.profiler`` session runs, as torch's own flag says
(``torch.autograd.profiler._is_profiler_enabled``, set at the start of
every session whatever its activities). Otherwise it returns one shared
no-op context after that single check. No span goes through
``record_function``, so none shows on the device's timeline.

While recording, each span keeps in memory its name, its parent (the span
open around it on its thread), a call id (new at each outermost span and
shared by every span under it) and its start and end on
``time.perf_counter_ns``. Its self time is its duration less the part that
its child spans cover. The store is bounded: a ring of the last ``RING``
spans, and the last ``PER_NAME`` durations of each name. What it keeps
holds no object that the garbage collector tracks, so recording moves no
collection into the calls it records.

``device=True`` (the block graph's span and its stages, on a CUDA device
only): one outermost such span in ``DEVICE_EVERY`` opens a timeline, a
timing event recorded on the current stream as it opens; each such span
inside it records one when it closes. So consecutive stages share a
boundary, and each stage's device interval is read in stream order, from
the previous event to its own. A timeline is read when a later one closes
and the device has passed its last event (``query``), never by a sync
inside the call, and its events are recorded again; ``summary`` waits for
the rest.

``summary()`` gives per span name the count and the medians; ``reset()``
clears the store. ``device_trace(log_dir)`` records a ``torch.profiler``
trace of the enclosed block into ``trace.json``, with the program's spans
merged in as a host track on the trace's clock, and writes ``spans.json``:
the kernels' device time by the span their launch was made in, and the
device's idle gaps by the span open on the host at their midpoint.

The port's spans, and the metric that reads each (PERF.md §3):

- ``graph`` (device): a call of the block graph (``dsp/block.py``);
- ``graph.clip``, ``graph.fft``, ``graph.doppler``, ``graph.mask_bank``,
  ``graph.timing``, ``graph.centres`` (device): its stages;
- ``launch``: a call into the kernel library (``ops/_lib.py``);
- ``download.start``, ``download.wait``: a packed result's copy to pinned
  host memory and the wait for it (``models/demodulator.py``);
- ``upload``: ``Demodulator._upload``; ``heal``: ``BlockHealer.heal``;
- ``decode.frames``, ``decode.rs``: the decoder's frame search and RS.
"""

import bisect
import collections
import contextlib
import functools
import itertools
import json
import logging
import os
import statistics
import struct
import threading
import sys
import time
from typing import NamedTuple, Optional

log = logging.getLogger(__name__)

#: spans kept whole (a call of the block graph makes about a dozen)
RING = 1 << 16
#: durations kept for each name's medians
PER_NAME = 4096
#: device timelines not read yet; beyond, the oldest is read at once
PENDING = 64
#: one outermost device span in this many opens a timeline (the first, then
#: every DEVICE_EVERY-th): a timeline's CUDA calls (six events recorded, five
#: intervals and a query read, a stream lookup) took about 0.17 ms of host
#: time a call of the block graph under the profiler on an H100 host
DEVICE_EVERY = 8

GRAPH = "graph"
LAUNCH = "launch"


class _Flag:
    """Where ``torch.autograd.profiler`` lacks its module flag: torch's
    C-side state, under the same attribute name."""

    @property
    def _is_profiler_enabled(self) -> bool:
        import torch

        return torch.autograd._profiler_enabled()


def _find_flag():
    """What holds torch's profiler flag, or None while this process has not
    loaded torch (the decoder and Tx children never do: this module imports
    no torch, and no profiler runs without it)."""
    prof = sys.modules.get("torch.autograd.profiler")
    if prof is None:
        return None
    return prof if isinstance(getattr(prof, "_is_profiler_enabled", None), bool) else _Flag()


class _Unloaded:
    """The flag until torch is loaded: off, and found once it is."""

    @property
    def _is_profiler_enabled(self) -> bool:
        global _profiler
        found = _find_flag()
        if found is None:
            return False
        _profiler = found
        return found._is_profiler_enabled


_profiler = _find_flag() or _Unloaded()


def recording() -> bool:
    """True while a ``torch.profiler`` session runs: spans record."""
    return _profiler._is_profiler_enabled


class _Off:
    """The span while nothing records: one shared object, no state."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_OFF = _Off()


class Record(NamedTuple):
    """A recorded span. ``parent``: the id of the span open around it on its
    thread, or None; ``launch_ns``: on ``graph``, its ``launch`` spans'
    summed host ns; ``events``: how many timing events the device span
    that opened a timeline recorded; ``device_ms``: its device interval, or
    None."""

    id: int
    name: str
    parent: Optional[int]
    call: int
    tid: int
    t0: int
    t1: int
    self_ns: int
    launch_ns: int
    events: int
    device_ms: Optional[float] = None


#: a span as the ring keeps it: id, name index, parent id (0: none), call,
#: thread, t0, t1, self ns, launch ns, events. Packed into bytes, which the
#: garbage collector does not track: recording adds nothing to its work
_PACK = struct.Struct("<10q")


class Span:
    """An open span (dropped when it closes). ``owner``: the outermost
    device span around it (itself for that span), whose ``timeline`` holds
    its stream and events and ``timed`` the intervals to read. A device
    span's own event is recorded inside its host interval."""

    __slots__ = ("name", "device", "parent", "owner", "call", "id", "tid", "stack", "t0",
                 "child_ns", "launch_ns", "timeline", "timed")

    def __init__(self, name: str, device: bool):
        self.name = name
        self.device = device
        self.child_ns = self.launch_ns = 0
        self.timeline = self.timed = None

    def __enter__(self):
        t0 = time.perf_counter_ns()  # the span's own bookkeeping counts in it
        th = _thread()
        stack = self.stack = th.stack
        parent = self.parent = stack[-1] if stack else None
        self.owner = parent.owner if parent is not None else None
        self.call = parent.call if parent is not None else next(_store.calls)
        self.id = next(_store.ids)
        self.tid = th.tid
        stack.append(self)
        self.t0 = t0
        if self.device and self.owner is None:
            self.owner = self
            if next(_store.owners) % DEVICE_EVERY == 0:  # this one opens a timeline
                import torch

                stream = torch.cuda.current_stream()
                ev = _store.event()
                ev.record(stream)
                self.timeline, self.timed = [stream, ev], []
        return self

    def __exit__(self, exc_type, exc, tb):
        owner = self.owner
        events = 0
        if self.device and owner is not None and owner.timeline is not None:
            tl = owner.timeline
            if owner is not self or len(tl) == 2:  # a stage's end, or an end of its own
                ev = _store.event()
                ev.record(tl[0])
                tl.append(ev)
            if owner is self:
                events = len(tl) - 1
            owner.timed.append((self.id, self.name, tl[-2] if owner is not self else tl[1],
                                tl[-1]))
        stack = self.stack
        if stack and stack[-1] is self:
            stack.pop()
        t1 = time.perf_counter_ns()
        parent = self.parent
        dur = t1 - self.t0
        if parent is not None:
            parent.child_ns += dur
        if self.name == LAUNCH:
            g = parent
            while g is not None and g.name != GRAPH:
                g = g.parent
            if g is not None:
                g.launch_ns += dur
        _store.add(self, t1, dur - self.child_ns, events)
        self.owner = self.timeline = self.timed = None  # the owner refers to itself
        return False


class _Thread:
    """A recording thread's open spans and native id (read once: the
    call is a system call)."""

    __slots__ = ("stack", "tid")

    def __init__(self):
        self.stack = []
        self.tid = threading.get_native_id()


_local = threading.local()


def _thread() -> _Thread:
    try:
        return _local.thread
    except AttributeError:
        th = _local.thread = _Thread()
        return th


class _Name:
    """A span name's index in the ring, its count since the last reset and
    its last ``PER_NAME`` host, self and device times."""

    __slots__ = ("index", "count", "host", "own", "device")

    def __init__(self, index: int):
        self.index, self.count = index, 0
        self.host, self.own, self.device = (collections.deque(maxlen=PER_NAME)
                                            for _ in range(3))


class _Store:
    """The recorded spans of this process: a ring of packed spans, per name
    bounded queues of numbers, and the device timelines not read yet.

    It grows no object that the garbage collector tracks: a timeline is
    read once the device has passed its last event (checked when the next
    one closes), and its events are recorded again."""

    def __init__(self):
        self.lock = threading.Lock()
        self.reset()

    def reset(self):
        with self.lock:
            self.free = []  # timing events read and free to record again
            self.ring = collections.deque(maxlen=RING)
            self.per = {}  # name -> _Name
            self.name_of = []  # name index -> name
            self.device_ms = {}  # span id -> device ms, for the ring's spans
            self.launch = collections.deque(maxlen=PER_NAME)  # graph: launch ns a call
            self.pending = collections.deque()  # (events, intervals) not read yet
            self.ids = itertools.count(1)
            self.calls = itertools.count(1)
            self.owners = itertools.count()

    def event(self):
        """A timing ``torch.cuda.Event``: one read before, or a new one
        (creating one costs far more than recording it)."""
        try:
            return self.free.pop()
        except IndexError:
            import torch

            return torch.cuda.Event(enable_timing=True)

    def _name(self, name: str) -> "_Name":
        n = self.per[name] = _Name(len(self.name_of))
        self.name_of.append(name)
        return n

    def add(self, s: Span, t1: int, self_ns: int, events: int):
        with self.lock:
            n = self.per.get(s.name) or self._name(s.name)
            n.count += 1
            n.host.append(t1 - s.t0)
            n.own.append(self_ns)
            self.ring.append(_PACK.pack(s.id, n.index, 0 if s.parent is None else s.parent.id,
                                        s.call, s.tid, s.t0, t1, self_ns, s.launch_ns, events))
            if s.name == GRAPH:
                self.launch.append(s.launch_ns)
            if s.timeline is not None:
                self.pending.append((s.timeline[1:], s.timed))
                if self.pending[0][0][-1].query() or len(self.pending) > PENDING:
                    self._read(self.pending.popleft())

    def _read(self, pending):
        """Read the device intervals of one timeline (waiting for its last
        event; the outermost span's, last, is the sum of its stages') and
        free its events."""
        events, timed = pending
        events[-1].synchronize()
        stages = 0.0
        for j, (sid, name, a, b) in enumerate(timed):
            last = j == len(timed) - 1
            ms = stages if last and j else a.elapsed_time(b)
            stages += ms
            self.per[name].device.append(ms)
            self.device_ms[sid] = ms
        while len(self.device_ms) > RING:
            del self.device_ms[next(iter(self.device_ms))]
        self.free.extend(events)

    def resolve(self):
        """Read every pending device interval."""
        with self.lock:
            while self.pending:
                self._read(self.pending.popleft())

    def records(self) -> list:
        dm, names = self.device_ms, self.name_of
        out = []
        for raw in self.ring:
            i, k, parent, *rest = _PACK.unpack(raw)
            out.append(Record(i, names[k], parent or None, *rest, dm.get(i)))
        return out


_store = _Store()


def span(name: str, device: bool = False):
    """``with span(name): ...`` records the block while a ``torch.profiler``
    session runs and costs one flag check otherwise. ``device=True``: also
    time it on the current CUDA stream (see the module's docstring); pass
    it on a CUDA device only."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return Span(name, device)


def traced(name: str):
    """Decorator: run the function inside ``span(name)``."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return inner

    return wrap


def reset() -> None:
    """Forget every recorded span."""
    _store.reset()


def records() -> list:
    """The recorded spans still in the ring, oldest first, as ``Record``s
    (device intervals read, waiting for the device where it has not passed
    them)."""
    _store.resolve()
    with _store.lock:
        return _store.records()


def summary() -> dict:
    """Per span name: ``count`` (every span recorded since the last reset),
    ``host_ms_p50`` and ``self_ms_p50``, ``device_ms_p50`` where the span
    is device-timed (over the calls timed), and for ``graph``
    ``launch_ms_per_call_p50``, the median per call of the summed
    ``launch`` spans inside it. Medians over the last ``PER_NAME`` of each.
    Empty when nothing was recorded."""
    _store.resolve()
    with _store.lock:
        out = {}
        for name, n in _store.per.items():
            if not n.host:
                continue
            e = {"count": n.count, "host_ms_p50": statistics.median(n.host) / 1e6,
                 "self_ms_p50": statistics.median(n.own) / 1e6}
            if n.device:
                e["device_ms_p50"] = statistics.median(n.device)
            if name == GRAPH and _store.launch:
                e["launch_ms_per_call_p50"] = statistics.median(_store.launch) / 1e6
            out[name] = e
        return out


def _clock_offset_ns() -> int:
    """``time.time_ns()`` less ``time.perf_counter_ns()``, from the
    tightest of a few paired readings."""
    best = None
    for _ in range(8):
        a = time.perf_counter_ns()
        w = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, w - (a + b) // 2)
    return best[1]


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Record a ``torch.profiler`` trace of the enclosed block (the device's
    activity on a card, the host's without one) into ``log_dir/trace.json``
    (a Chrome trace, for ``chrome://tracing`` or Perfetto), with the
    program's spans of the block as a host track; then write
    ``log_dir/spans.json`` (``attribute``). Yields the profiler."""
    import torch

    cuda = torch.cuda.is_available()
    acts = [torch.profiler.ProfilerActivity.CUDA if cuda else torch.profiler.ProfilerActivity.CPU]
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    offset = _clock_offset_ns()
    prof.start()
    t0 = time.perf_counter_ns()
    try:
        yield prof
    finally:
        if cuda:
            torch.cuda.synchronize()
        t1 = time.perf_counter_ns()
        prof.stop()
        path = os.path.join(log_dir, "trace.json")
        prof.export_chrome_trace(path)
        every = records()
        spans = [s for s in every if s.t1 >= t0 and s.t0 <= t1]
        with open(path) as f:
            trace = json.load(f)
        base = int(trace.get("baseTimeNanoseconds", 0))
        trace["traceEvents"].extend(_host_track(spans, offset - base))
        with open(path, "w") as f:
            json.dump(trace, f)
        with open(os.path.join(log_dir, "spans.json"), "w") as f:
            json.dump(attribute(trace["traceEvents"], spans, offset - base, t0, t1, every), f,
                      indent=1)
        log.info("device trace written to %s", path)


#: the program's spans in trace.json: a thread id of their own for each
#: recording thread (its native id plus this)
SPAN_TID = 1 << 40


def _us(ns: int, shift: int) -> float:
    return (ns + shift) / 1e3


def _host_track(spans, shift: int) -> list:
    """Chrome trace events of ``spans``, a thread a recording thread, on
    the trace's clock (``shift``: perf_counter ns to the trace's ns)."""
    pid = os.getpid()
    out = [{"ph": "M", "name": "thread_name", "pid": pid, "tid": SPAN_TID + t,
            "args": {"name": f"program spans (thread {t})"}} for t in {s.tid for s in spans}]
    for s in spans:
        out.append({"ph": "X", "cat": "program_span", "name": s.name, "pid": pid,
                    "tid": SPAN_TID + s.tid, "ts": _us(s.t0, shift), "dur": (s.t1 - s.t0) / 1e3,
                    "args": {"call": s.call, "id": s.id, "parent": s.parent,
                             "self_us": s.self_ns / 1e3, "device_ms": s.device_ms}})
    return out


class _Open:
    """The innermost span open at a time, thread by thread; ``every``: the
    records to find parents in."""

    def __init__(self, spans, shift: int, every):
        self.by_id = {s.id: s for s in every}
        self.by_tid = {}
        for s in sorted(spans, key=lambda s: s.t0):
            self.by_tid.setdefault(s.tid, []).append(s)
        self.starts = {t: [_us(s.t0, shift) for s in v] for t, v in self.by_tid.items()}
        self.shift = shift

    def parent(self, s):
        return None if s.parent is None else self.by_id.get(s.parent)

    def at(self, us: float, tid=None):
        """The innermost span open at ``us`` on thread ``tid`` (on any
        thread, the deepest, where ``tid`` recorded none), or None."""
        tids = [tid] if tid in self.by_tid else list(self.by_tid)
        best, depth = None, -1
        for t in tids:
            j = bisect.bisect_right(self.starts[t], us) - 1
            s = self.by_tid[t][j] if j >= 0 else None
            while s is not None and _us(s.t1, self.shift) < us:
                s = self.parent(s)  # the span open at us is an ancestor of the last started
            if s is not None:
                d, p = 0, self.parent(s)
                while p is not None:
                    d, p = d + 1, self.parent(p)
                if d > depth:
                    best, depth = s, d
        return best


def attribute(events, spans, shift: int, t0: int, t1: int, every) -> dict:
    """What ``spans.json`` holds, from a trace's events and the program's
    spans of its window [t0, t1] (perf_counter ns; ``shift`` to the
    trace's ns; ``every``: the records to find parents in):

    - per span name: ``count``, summed ``host_ms``, ``self_ms`` and
      ``device_ms`` (the span's own events), ``kernel_ms`` (device time of
      the kernels launched while it was the innermost open span) and
      ``kernel_ms_incl`` (with the kernels of the spans inside it). A
      kernel is matched to its launch through the trace's correlation id;
    - ``kernel_ms`` of the whole trace and ``kernel_ms_in_spans``;
    - ``idle_gaps``: the window's time with no kernel and no copy on the
      device, summed under the innermost span open on the host at each
      gap's midpoint ("none" where no span is), largest first."""
    launches, kernels, busy = {}, [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        corr = (e.get("args") or {}).get("correlation")
        if cat in ("cuda_runtime", "cuda_driver") and corr is not None:
            launches[corr] = (e["ts"], e.get("tid"))
        elif cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            busy.append((e["ts"], e["ts"] + e.get("dur", 0.0)))
            if cat == "kernel":
                kernels.append((corr, e.get("dur", 0.0)))
    open_at = _Open(spans, shift, every)
    per = {}
    for s in spans:
        p = per.setdefault(s.name, dict(count=0, host_ms=0.0, self_ms=0.0, device_ms=0.0,
                                        kernel_ms=0.0, kernel_ms_incl=0.0))
        p["count"] += 1
        p["host_ms"] += (s.t1 - s.t0) / 1e6
        p["self_ms"] += s.self_ns / 1e6
        p["device_ms"] += s.device_ms or 0.0
    in_spans = total = 0.0
    for corr, dur in kernels:
        total += dur / 1e3
        at = launches.get(corr)
        s = open_at.at(*at) if at is not None else None
        if s is None:
            continue
        in_spans += dur / 1e3
        if s.name in per:
            per[s.name]["kernel_ms"] += dur / 1e3
        while s is not None:
            if s.name in per:
                per[s.name]["kernel_ms_incl"] += dur / 1e3
            s = open_at.parent(s)
    lo, hi = _us(t0, shift), _us(t1, shift)
    gaps, end = {}, lo
    for a, b in sorted(busy) + [(hi, hi)]:
        if a > end and end < hi:
            a = min(a, hi)
            s = open_at.at(0.5 * (a + end))
            name = "none" if s is None else s.name
            gaps[name] = gaps.get(name, 0.0) + (a - end) / 1e3
        end = max(end, b)
    return {"window_ms": (t1 - t0) / 1e6, "kernel_ms": total, "kernel_ms_in_spans": in_spans,
            "kernels": len(kernels), "spans": per,
            "idle_gaps": sorted(([k, v] for k, v in gaps.items()), key=lambda kv: -kv[1])}
