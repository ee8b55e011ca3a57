"""Spans and counters of the port's own layers, kept in memory on the
host's clock, with the card's time of the spans that ask for it.

Recording is on for one command-line call (`command`) when a torch
profiler is recording as the call starts, or when the call asks for the
summary table (`--verbosity 2` or more); otherwise every site below costs
one flag test:

    with trace.span("dock.search", device=dev, lanes=64):
        ...
    trace.count("mc.windows")
    trace.count_device("mc.steps_completed", stats[:, 4])

A span is (id, parent, call, name, host start and end in
`time.perf_counter_ns()`, thread, attributes).  Its parent is the span
open on the same thread, or the one handed over by `adopt` to a worker
thread.  A span opened with a CUDA `device` records one timing event on
that device's current stream at entry and one at exit, and never waits:
`snapshot` places the events on the host's clock on the line through the
call's reference event (stamped once per call and device, after the
stream has drained) and a closing one it takes itself, so a span's host
interval, its device interval and a profiler's kernel intervals, once on
`perf_counter_ns`, compare directly.  A device
counter holds references to tensors the kernels already return and sums
them only in `snapshot`: counting launches no kernel.

The recorder emits no profiler range of its own (no `record_function`,
no NVTX): a profiler session sees the program's kernels and nothing else.
Kernel launches are counted by the kernels' own wrappers
(`ops.fused_dock.KERNELS`); the snapshot reports what they counted since
the record was last cleared.  The record clears itself when a call turns
recording on after a call that had it off, and on `reset`; spans past
`CAP` are dropped and counted under `trace.dropped`.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import Dict, List, Optional

import torch

CAP = 1 << 20


class _NoSpan:
    """The span of every site while recording is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP = _NoSpan()


class _Span:
    """A recorded span: host stamps, and device events on its stream."""

    __slots__ = ("id", "parent", "call", "name", "t0", "t1", "thread",
                 "attrs", "stream", "ev0", "ev1")

    def __init__(self, name, device, attrs):
        self.name = name
        self.attrs = attrs
        self.t1 = None
        self.stream = None
        self.ev0 = self.ev1 = None
        if device is not None and torch.device(device).type == "cuda":
            self.stream = torch.cuda.current_stream(device)

    def __enter__(self):
        rec = _REC
        stack = rec.stack()
        self.id = next(rec.ids)
        self.parent = stack[-1] if stack else None
        self.call = rec.call
        self.thread = threading.get_ident()
        if self.stream is not None:
            rec.reference(self.call, self.stream)
            self.ev0 = torch.cuda.Event(enable_timing=True)
            self.ev0.record(self.stream)
        stack.append(self.id)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter_ns()
        if self.stream is not None:
            self.ev1 = torch.cuda.Event(enable_timing=True)
            self.ev1.record(self.stream)
        _REC.stack().pop()
        _REC.add(self)
        return False


class Recorder:
    """The process's record: spans, counters and the reference events of
    the calls since it was last cleared."""

    def __init__(self):
        self.on = False
        self.call: Optional[int] = None
        self.last_on = False
        self.ids = itertools.count(1)
        self.calls = itertools.count(1)
        self._local = threading.local()
        self._lock = threading.Lock()
        self._empty({})

    def _empty(self, launch_base: Dict[str, int]):
        self.spans: List[_Span] = []
        self.counts: Dict[tuple, int] = collections.Counter()
        self.device_counts: Dict[tuple, list] = collections.defaultdict(list)
        self.refs: Dict[tuple, tuple] = {}
        self.launch_base = launch_base
        self.call_launch_base: Dict[int, Dict[str, int]] = {}
        self.opened = 0
        self.dropped = 0

    def clear(self):
        base = _launches()
        with self._lock:
            self._empty(base)

    def stack(self) -> list:
        s = getattr(self._local, "stack", None)
        if s is None:
            s = self._local.stack = []
        return s

    def admit(self) -> bool:
        """Whether one more span fits under CAP; counts it dropped if not."""
        with self._lock:
            if self.opened < CAP:
                self.opened += 1
                return True
            self.dropped += 1
            return False

    def add(self, sp: _Span):
        with self._lock:
            self.spans.append(sp)

    def reference(self, call: int, stream):
        """The call's reference event on the stream's device (`_stamp`)."""
        key = (call, stream.device_index)
        if key in self.refs:
            return
        with self._lock:
            if key not in self.refs:
                self.refs[key] = _stamp(stream)

    def start_call(self, on: bool) -> int:
        if on and not self.last_on:
            self.clear()
        self.call = next(self.calls)
        self.on = on
        if on:
            self.call_launch_base[self.call] = _launches()
            if torch.cuda.is_available() and torch.cuda.is_initialized():
                self.reference(self.call, torch.cuda.current_stream())
        return self.call

    def end_call(self):
        self.last_on = self.on
        self.on = False

    def snapshot(self, call: Optional[int] = None) -> dict:
        """Every closed span and counter (of one call, or of all since the
        record was last cleared), device times resolved, self times
        computed; waits for each card that the record used."""
        with self._lock:
            spans = [s for s in self.spans
                     if call is None or s.call == call]
            counts = dict(self.counts)
            device_counts = {k: list(v) for k, v in
                             self.device_counts.items()}
            base = (self.launch_base if call is None
                    else self.call_launch_base.get(call, {}))
            refs = dict(self.refs)
            dropped = self.dropped
        # a closing reference a device: each call's events are placed
        # between its own reference and this one, which takes out the
        # drift of the card's clock against the host's
        closing = {}
        for (c, i), ref in refs.items():
            if i not in closing:
                torch.cuda.synchronize(i)
                closing[i] = _stamp(ref[3])
        place = {k: _placer(ref, closing[k[1]]) for k, ref in refs.items()}
        out = []
        for s in sorted(spans, key=lambda x: x.id):
            d0 = d1 = None
            if s.ev1 is not None:
                p = place[(s.call, s.stream.device_index)]
                d0, d1 = p(s.ev0), p(s.ev1)
            out.append(dict(id=s.id, parent=s.parent, call=s.call,
                            name=s.name, t0=s.t0, t1=s.t1, thread=s.thread,
                            attrs=dict(s.attrs), d0=d0, d1=d1))
        _self_times(out)
        counters = collections.Counter()
        for (c, name), v in counts.items():
            if call is None or c == call:
                counters[name] += v
        for (c, name), ts in device_counts.items():
            if call is None or c == call:
                counters[name] += int(sum(float(t.double().sum())
                                          for t in ts))
        if dropped:
            counters["trace.dropped"] = dropped
        now = _launches()
        launches = {k: v - base.get(k, 0) for k, v in now.items()
                    if v - base.get(k, 0)}
        return dict(spans=out, counters=dict(counters),
                    kernel_launches=launches,
                    clock_err_ns=max((r[2] for k, r in refs.items()
                                      if call is None or k[0] == call),
                                     default=None))


TRIES = 4


def _stamp(stream) -> tuple:
    """An event on the drained stream placed on the host's clock: of TRIES
    round trips (stamp, record, wait, stamp), the one with the shortest
    wait, stamped halfway.  Returns (event, stamp ns, half the wait ns,
    stream)."""
    stream.synchronize()
    best = None
    for _ in range(TRIES):
        ev = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter_ns()
        ev.record(stream)
        ev.synchronize()
        t1 = time.perf_counter_ns()
        if best is None or t1 - t0 < 2 * best[2]:
            best = (ev, (t0 + t1) // 2, (t1 - t0) // 2, stream)
    return best


def _placer(ref: tuple, close: tuple):
    """event -> ns on the host's clock, on the line through the two
    references (host ns per device ns between them)."""
    ev, stamp = ref[0], ref[1]
    span = ev.elapsed_time(close[0]) * 1e6
    rate = (close[1] - stamp) / span if span > 0 else 1.0
    return lambda e: stamp + int(ev.elapsed_time(e) * 1e6 * rate)


def _launches() -> Dict[str, int]:
    from gnina_tpu_torch.ops import fused_dock

    return {k.name: k.launches for k in fused_dock.KERNELS}


def _covered(intervals, t0: int, t1: int) -> int:
    """ns of [t0, t1] covered by the union of the intervals."""
    total, end = 0, t0
    for a, b in sorted(intervals):
        a, b = max(a, end), min(b, t1)
        if b > a:
            total += b - a
            end = b
    return total


def _self_times(spans: List[dict]):
    """span["self_ns"]: its duration less the part its children cover."""
    children = collections.defaultdict(list)
    for s in spans:
        if s["t1"] is not None and s["parent"] is not None:
            children[s["parent"]].append((s["t0"], s["t1"]))
    for s in spans:
        if s["t1"] is None:
            s["self_ns"] = None
            continue
        s["self_ns"] = (s["t1"] - s["t0"]
                        - _covered(children.get(s["id"], ()), s["t0"],
                                   s["t1"]))


_REC = Recorder()


def span(name: str, device=None, **attrs):
    """A context manager around one piece of work: a recorded span while
    recording is on, else the shared no-op."""
    if not _REC.on or not _REC.admit():
        return NOOP
    return _Span(name, device, attrs)


def count(name: str, n: int = 1):
    if _REC.on:
        with _REC._lock:
            _REC.counts[(_REC.call, name)] += int(n)


def count_device(name: str, t: torch.Tensor):
    """Adds the sum of `t` (read in `snapshot`) to the counter."""
    if _REC.on:
        with _REC._lock:
            _REC.device_counts[(_REC.call, name)].append(t)


def current() -> Optional[int]:
    """The id of the span open on this thread (None: none, or off)."""
    if not _REC.on:
        return None
    s = _REC.stack()
    return s[-1] if s else None


class _Adopt:
    __slots__ = ("parent",)

    def __init__(self, parent: int):
        self.parent = parent

    def __enter__(self):
        _REC.stack().append(self.parent)
        return self

    def __exit__(self, *exc):
        _REC.stack().pop()
        return False


def adopt(parent: Optional[int]):
    """On a worker thread: spans opened inside are children of `parent`
    (`current()` on the thread that handed the work over)."""
    if parent is None or not _REC.on:
        return NOOP
    return _Adopt(parent)


def profiler_on() -> bool:
    return torch.autograd._profiler_enabled()


@contextlib.contextmanager
def command(table: bool):
    """One command-line call, recorded as the span `cli.main` when a
    profiler is recording or `table` asks for the summary."""
    _REC.start_call(table or profiler_on())
    try:
        with span("cli.main"):
            yield _REC.call
    finally:
        _REC.end_call()


def snapshot(call: Optional[int] = None) -> dict:
    """The record since recording last turned on (or one call's):
    dict(spans, counters, kernel_launches, clock_err_ns).  Each span is
    a dict with id, parent, call, name, thread, attrs, t0, t1 and self_ns
    (host, ns) and d0, d1 (its device interval, ns on the host's clock;
    None without a device)."""
    return _REC.snapshot(call)


def reset():
    """Clears the record; the next call that records starts a new one."""
    _REC.clear()
    _REC.last_on = False


def summary(call: Optional[int] = None) -> str:
    """A table of spans by name (count, total, self and device seconds),
    the counters and the kernel launches, of one call or of the record."""
    snap = snapshot(call)
    rows: Dict[str, list] = {}
    for s in snap["spans"]:
        r = rows.setdefault(s["name"], [0, 0, 0, None])
        r[0] += 1
        r[1] += s["t1"] - s["t0"]
        r[2] += s["self_ns"]
        if s["d0"] is not None:
            r[3] = (r[3] or 0) + s["d1"] - s["d0"]
    lines = ["Trace (seconds; device: between the span's events on the "
             "card)",
             f"{'span':<16}{'count':>8}{'total':>11}{'self':>11}"
             f"{'device':>11}"]
    for name, (n, tot, own, dev) in rows.items():
        d = f"{dev / 1e9:11.3f}" if dev is not None else f"{'-':>11}"
        lines.append(f"{name:<16}{n:>8}{tot / 1e9:11.3f}{own / 1e9:11.3f}"
                     f"{d}")
    for name, v in sorted(snap["counters"].items()):
        lines.append(f"{name:<24}{v:>15}")
    for name, v in sorted(snap["kernel_launches"].items()):
        lines.append(f"{'launches ' + name:<24}{v:>15}")
    return "\n".join(lines) + "\n"
