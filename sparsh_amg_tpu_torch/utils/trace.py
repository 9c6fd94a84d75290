"""Where a solve's device time and a new matrix's host time go: the
port's one tracer.

Off by default.  Off, ``span()`` hands back one shared no-op context,
``count()``, ``stamp()`` and ``device_op()`` return at once and a
function decorated with ``spanned()`` is called as it is: no
allocation, no clock read, no event, and graphs captured while it is off
hold no node of its own.  ``timed()`` always reads the clock (the graphs'
``capture_s``, ``instantiate_s`` and ``build_s`` come from it) and
records a span only while tracing is on.  Nothing is written to disk and
no environment variable switches anything: a caller turns it on with
``enable()`` and takes what it kept with ``export()``.

* **Spans** (host): name, start and end in ``time.perf_counter_ns()``,
  the parent span, a request id shared by every span under one root span,
  and attributes; ``span()`` around a block, ``spanned()`` around each
  call of a function.
* **Counters**: ``count(name, n)``; a ``Tally`` counts whether tracing
  is on or off, and graphs replay it (the distributed solver's
  collectives).
* **Device intervals**: a pair of CUDA events around a device operation
  (``device_op``, or events the caller already has: ``note_events``).
  ``anchor()`` records an event on an idle device just after a
  synchronise, between two host clock reads; ``export()`` maps every
  interval onto the host clock by the line through the first and the last
  anchor, so the two clocks' drift over a long window cancels, and gives
  each anchor's bracket (the two host reads' distance).
* **Stamps** (device, inside captured graphs): within ``stamping()`` (the
  the Krylov loop's step, ``solve/solver.py::_Loop``) each ``stamp()``
  issues the one-thread kernel ``trace_stamp`` (``csrc/graph_loop.cu``),
  which reads the device's global timer, adds the time since the previous
  stamp to its slot and 1 to the slot's count; a reset stamp only takes
  the time.  The step is ``step.begin`` (reset), ``enter[l]`` at the top
  and ``leave[l]`` at the return of each visit to level l
  (``solve/cycles.py``), ``step.end``.  So the time in ``enter[l+1]`` is
  level l's pre-smoothing, residual and restriction; in ``leave[l]`` level
  l's prolongation and post-smoothing, or on the coarsest level its coarse
  solve; in ``enter[0]`` and ``step.end`` the Krylov step's own work.
  On the CPU the same runs with ``perf_counter_ns``.
"""
from __future__ import annotations

import functools
import time

import torch

STAMP_SLOTS = 128           # slots of a stamp buffer: 2 L + 2 are used


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


_NOOP = _Noop()


class _Tracer:
    """What the tracer keeps (one per process, ``_T``)."""

    def __init__(self):
        self.on = False
        self.spans = []             # one dict per span, in start order
        self.stack = []             # the open spans' dicts
        self.counters = {}
        self.intervals = []         # (name, start event, end event)
        self.anchors = []           # (host ns before, event, host ns after)
        self.requests = 0
        self.slots = {}             # stamp name -> slot (kept by reset:
                                    # captured graphs hold the slots)
        self.buffers = {}           # device -> int64 (2 STAMP_SLOTS + 1,):
                                    # ns a slot, counts a slot, last stamp
        self.stamp_device = None    # set inside stamping()


_T = _Tracer()


def enable() -> None:
    _T.on = True


def disable() -> None:
    _T.on = False


def enabled() -> bool:
    return _T.on


def reset() -> None:
    """Forget every span, counter, device interval and anchor, and zero
    the stamp buffers in place (their slots stay: graphs captured with
    stamps keep using them)."""
    _T.spans, _T.stack, _T.counters = [], [], {}
    _T.intervals, _T.anchors = [], []
    _T.requests = 0
    for buf in _T.buffers.values():
        buf.zero_()


class _Span:
    __slots__ = ("rec",)

    def __init__(self, name: str, attrs: dict, t0: int | None = None):
        parent = _T.stack[-1] if _T.stack else None
        if parent is None:
            _T.requests += 1
            request = _T.requests
        else:
            request = parent["request"]
        self.rec = {"name": name, "start_ns": t0, "end_ns": None,
                    "parent": None if parent is None else parent["index"],
                    "request": request, "attrs": attrs,
                    "index": len(_T.spans)}

    def __enter__(self):
        if self.rec["start_ns"] is None:
            self.rec["start_ns"] = time.perf_counter_ns()
        _T.spans.append(self.rec)
        _T.stack.append(self.rec)
        return self

    def close(self, t1: int) -> None:
        self.rec["end_ns"] = t1
        if _T.stack and _T.stack[-1] is self.rec:
            _T.stack.pop()

    def __exit__(self, *exc):
        self.close(time.perf_counter_ns())
        return False

    def set(self, **attrs) -> None:
        self.rec["attrs"].update(attrs)


def span(name: str, **attrs):
    """A context for one host span (``set(**attrs)`` adds attributes
    before it closes); the shared no-op context while tracing is off."""
    if not _T.on:
        return _NOOP
    return _Span(name, attrs)


def spanned(name: str, result_attrs=None):
    """A decorator: each call of the function is the span `name`, with
    ``result_attrs(result)`` (a dict) as attributes when given; while
    tracing is off the function is called as it is."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _T.on:
                return fn(*args, **kwargs)
            with _Span(name, {}) as sp:
                out = fn(*args, **kwargs)
                if result_attrs is not None:
                    sp.set(**result_attrs(out))
            return out
        return call
    return wrap


class timed:
    """A span whose duration is kept in ``seconds`` whether tracing is on
    or off; it is recorded as a span only while tracing is on, from the
    same two clock reads."""

    def __init__(self, name: str, **attrs):
        self._name, self._attrs = name, attrs
        self._span = None
        self._t0 = 0
        self.seconds = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter_ns()
        if _T.on:
            self._span = _Span(self._name, self._attrs, self._t0).__enter__()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self._span is not None:
            self._span.close(t1)
        self.seconds = (t1 - self._t0) / 1e9
        return False


def count(name: str, n: int = 1) -> None:
    if _T.on:
        _T.counters[name] = _T.counters.get(name, 0) + n


class Tally:
    """A count kept whether tracing is on or off, in ``launches`` as a
    kernel wrapper keeps its launches: a capture takes back what it added
    and every replay adds it again (``solve/graphs.py``, a pass graph's
    step once per iteration it ran), so work issued inside graphs is
    counted as often as it runs.  ``tallies()`` lists every one."""

    __slots__ = ("__name__", "launches")

    def __init__(self, name: str):
        self.__name__ = name
        self.launches = 0
        _TALLIES.append(self)

    def add(self, n: int = 1) -> None:
        self.launches += n


_TALLIES = []


def tallies() -> tuple:
    return tuple(_TALLIES)


# ---------------------------------------------------------------------------
# Device intervals and anchors
# ---------------------------------------------------------------------------

class _DeviceOp:
    __slots__ = ("name", "ev")

    def __init__(self, name: str):
        self.name = name
        self.ev = None

    def __enter__(self):
        self.ev = torch.cuda.Event(enable_timing=True)
        self.ev.record()
        return self

    def __exit__(self, *exc):
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        _T.intervals.append((self.name, self.ev, end))
        return False


def device_op(name: str, device: torch.device):
    """Two CUDA events on the current stream around the device work issued
    inside, kept as the device interval `name`; nothing while tracing is
    off or off the card (a CPU operation is in its host span)."""
    if not _T.on or device.type != "cuda":
        return _NOOP
    return _DeviceOp(name)


def note_events(name: str, start, end) -> None:
    """Keep the events (start, end), already recorded by the caller, as the
    device interval `name`."""
    if _T.on:
        _T.intervals.append((name, start, end))


def anchor() -> None:
    """While tracing is on and a card is there: synchronise, read the host
    clock, record an event on the now idle device, wait for it and read the
    host clock again (the bracket ``export()`` reports)."""
    if not _T.on or not torch.cuda.is_available():
        return
    torch.cuda.synchronize()
    t0 = time.perf_counter_ns()
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    ev.synchronize()
    t1 = time.perf_counter_ns()
    _T.anchors.append((t0, ev, t1))


def _device_clock():
    """(first anchor's event, its host ns, host ns per device ms) from the
    first and last anchors; None without an anchor."""
    if not _T.anchors:
        return None
    a0, ev0, a1 = _T.anchors[0]
    mid0 = (a0 + a1) / 2
    rate = 1e6
    if len(_T.anchors) > 1:
        b0, ev1, b1 = _T.anchors[-1]
        ms = ev0.elapsed_time(ev1)
        if ms > 0:
            rate = ((b0 + b1) / 2 - mid0) / ms
    return ev0, mid0, rate


# ---------------------------------------------------------------------------
# Stamps inside the step graph
# ---------------------------------------------------------------------------

def trace_stamp(buf: torch.Tensor, slot: int, reset: bool) -> None:
    """One stamp on `buf` (int64, (2 S + 1,): S slots of ns, S counts, the
    last stamp's time): buf[slot] += now - last, buf[S + slot] += 1,
    last = now; a reset stamp only sets last.  On the card one launch of
    ``csrc/graph_loop.cu``'s one-thread kernel (now: the global timer, in
    ns); on the CPU its plain version (now: ``perf_counter_ns``)."""
    cap = (buf.numel() - 1) // 2
    if not 0 <= slot < cap:
        raise ValueError(f"stamp slot {slot} outside 0..{cap - 1}")
    if buf.dtype != torch.int64 or not buf.is_contiguous():
        raise ValueError("stamp buffer must be a contiguous int64 vector")
    dev = buf.device
    if dev.type == "cpu":
        now = time.perf_counter_ns()
        if not reset:
            buf[slot] += now - int(buf[2 * cap])
            buf[cap + slot] += 1
        buf[2 * cap] = now
    elif dev.type == "cuda":
        from .. import _build
        _build.check(_build.lib().trace_stamp_launch(
            buf.data_ptr(), cap, slot, int(reset),
            torch.cuda.current_stream(dev).cuda_stream), "trace_stamp")
    else:
        raise ValueError(f"no stamp kernel for device {dev}")
    trace_stamp.launches += 1


trace_stamp.launches = 0


def _buffer(device: torch.device) -> torch.Tensor:
    buf = _T.buffers.get(device)
    if buf is None:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the stamp buffer is allocated outside a "
                               "capture: run the stamped code eagerly first")
        buf = _T.buffers[device] = torch.zeros(
            2 * STAMP_SLOTS + 1, dtype=torch.int64, device=device)
    return buf


class _Stamping:
    __slots__ = ("device",)

    def __init__(self, device: torch.device):
        self.device = device

    def __enter__(self):
        _buffer(self.device)
        _T.stamp_device = self.device
        stamp("step.begin", reset=True)
        return self

    def __exit__(self, *exc):
        stamp("step.end")
        _T.stamp_device = None
        return False


def stamping(device: torch.device):
    """The stamped region (the Krylov loop's step): ``step.begin``
    (reset) on entry, ``step.end`` on exit, and every ``stamp()`` inside
    issues a stamp on `device`'s buffer; a no-op while tracing is off."""
    if not _T.on:
        return _NOOP
    return _Stamping(torch.device(device))


def stamp(kind: str, level: int | None = None, reset: bool = False) -> None:
    """A stamp named `kind` (``kind[level]`` with a level) inside
    ``stamping()``; nothing elsewhere or while tracing is off."""
    if not _T.on or _T.stamp_device is None:
        return
    name = kind if level is None else f"{kind}[{level}]"
    slot = _T.slots.get(name)
    if slot is None:
        if len(_T.slots) >= STAMP_SLOTS:
            raise RuntimeError(f"more than {STAMP_SLOTS} stamp names")
        slot = _T.slots[name] = len(_T.slots)
    trace_stamp(_buffer(_T.stamp_device), slot, reset)


# ---------------------------------------------------------------------------
# Export
# ---------------------------------------------------------------------------

def export() -> dict:
    """Everything kept, as plain numbers: ``spans`` (name, start_ns,
    end_ns, parent (index), request, attrs), ``counters``, ``device``
    (name, ms, and start_ns/end_ns on the host clock when an anchor was
    taken), ``anchors`` (host_ns, bracket_ns) and ``stamps`` ({name: {ns,
    count}} of the slots stamped since ``reset()``, summed over devices;
    the buffers are read once)."""
    spans = [{k: v for k, v in s.items() if k != "index"}
             for s in _T.spans]
    clock = _device_clock() if _T.intervals else None
    device = []
    for name, e0, e1 in _T.intervals:
        rec = {"name": name, "ms": e0.elapsed_time(e1)}
        if clock is not None:
            ev, mid, rate = clock
            rec["start_ns"] = mid + ev.elapsed_time(e0) * rate
            rec["end_ns"] = mid + ev.elapsed_time(e1) * rate
        device.append(rec)
    stamps = {}
    for buf in _T.buffers.values():
        host = buf.tolist()
        for name, slot in _T.slots.items():
            if host[STAMP_SLOTS + slot]:
                s = stamps.setdefault(name, {"ns": 0, "count": 0})
                s["ns"] += host[slot]
                s["count"] += host[STAMP_SLOTS + slot]
    return {"spans": spans, "counters": dict(_T.counters),
            "device": device,
            "anchors": [{"host_ns": (a + b) / 2, "bracket_ns": b - a}
                        for a, _, b in _T.anchors],
            "stamps": stamps}


def span_totals(spans: list) -> dict:
    """{name: {"count", "ns", "self_ns"}} over exported spans (open spans
    left out): a span's self time is its duration less its children's."""
    dur = [None if s["end_ns"] is None else s["end_ns"] - s["start_ns"]
           for s in spans]
    own = list(dur)
    for s, d in zip(spans, dur):
        if d is not None and s["parent"] is not None \
                and own[s["parent"]] is not None:
            own[s["parent"]] -= d
    out = {}
    for s, d, o in zip(spans, dur, own):
        if d is None:
            continue
        t = out.setdefault(s["name"], {"count": 0, "ns": 0, "self_ns": 0})
        t["count"] += 1
        t["ns"] += d
        t["self_ns"] += o
    return out
