"""Device profiling: trace a call with ``torch.profiler`` and summarize its device time.

Wall-clock numbers hide the decode's cost structure (a few hand-written
kernels among hundreds of small PyTorch kernels a step, and host gaps
between them); this module wraps the recipe that works on the card:

1. run the call under ``torch.profiler.profile`` with the CUDA activity
   only (tracing the CPU operators as well slows the host several times
   over), after a pre-roll of ``PRE_ROLL`` tiny float64 fills: a trace may drop the
   first kernels it sees, and then it drops these (left out of the sums),
   not the call's;
2. synchronize, so that every kernel the call enqueued is in the trace;
3. read the device rows (kernels, memsets, copies): totals by name, and the
   busy time as the union of their intervals (the naive sum double-counts
   overlapping kernels); a trace with no device rows, or one the caller's
   ``complete`` check rejects (say, fewer launches of a kernel than the
   call made), is taken again, up to ``tries`` times, as the profiler now
   and then returns an empty or a truncated one.

On a call that runs no CUDA work (a CPU decode) the report summarizes the
CPU operators instead, and its ``plane`` says ``"cpu"``: no number of it is
a device time. Typical use::

    from pyctcdecode_torch.utils.profiling import profile_call
    report = profile_call(lambda: decoder.decode_batch(batch, beam_width=100))
    print(report.table(top=20))

The JAX reference package's ``summarize_xplane`` read XLA's xplane protobuf;
:func:`summarize_trace` is its counterpart for a ``torch.profiler`` trace.

The host side has a tracer of its own: spans and counters that the package
records at the boundaries of its layers while a caller has tracing on::

    with profiling.tracing() as tr:
        decoder.decode_beams_batch(batch)
    spans, counters = tr.drain()

A public call opens a root span (``build``, ``batch``, ``stream.start``,
``chunk``) with a call id of its own (a stream's chunks share the id its
``get_starting_state`` took), and the stages inside it (``batch.prep``,
``batch.upload``, ...) follow one another under it, each ending where the
next begins, so that they tile the call. Times are ``time.perf_counter_ns``,
the host clock a caller's own spans use. Tracing is off unless a caller turns
it on: a site then checks one module-level reference (:data:`TRACER`) and
does nothing else. On, a site reads the clock and appends to lists: no CUDA
call, no synchronize, no event, and nothing inside a CUDA graph's capture
changes what is captured. A trace records the calls of one thread.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import time
from typing import Callable, Dict, Iterator, List, Optional, Tuple

PRE_ROLL = 64
PRE_ROLL_KERNEL = "FillFunctor<double>"  # the pre-roll's kernel (a decode fills no float64 tensor)


@dataclasses.dataclass
class OpTime:
    """Aggregated device time of one kernel (or, in a CPU trace, one operator)."""

    name: str
    total_ms: float
    share: float  # fraction of the summed per-op time
    count: int = 0  # launches (calls)


@dataclasses.dataclass
class TraceReport:
    """Timing of one traced call."""

    plane: str  # the device the rows ran on ("cuda:0"), or "cpu"
    busy_ms: float  # interval union of the rows
    summed_ms: float  # per-op sum (double-counts overlap)
    ops: List[OpTime]

    @property
    def launches(self) -> int:
        """Rows in the trace: kernels, memsets and copies (device ops)."""
        return sum(op.count for op in self.ops)

    def table(self, top: int = 20) -> str:
        """Human-readable top-N op table."""
        lines = [
            f"plane: {self.plane}",
            f"busy {self.busy_ms:.3f} ms (op-sum {self.summed_ms:.3f} ms, {self.launches} ops)",
        ]
        for op in self.ops[:top]:
            lines.append(f"{op.total_ms:9.3f} ms {100 * op.share:5.1f}% x{op.count:6d}  {op.name[:90]}")
        return "\n".join(lines)

    def grouped(self, buckets: Dict[str, Tuple[str, ...]]) -> Dict[str, float]:
        """Sum op time (ms) into caller-defined buckets by substring match; the rest under ``"other"``."""
        out = {name: 0.0 for name in buckets}
        out["other"] = 0.0
        for op in self.ops:
            for name, needles in buckets.items():
                if any(n in op.name for n in needles):
                    out[name] += op.total_ms
                    break
            else:
                out["other"] += op.total_ms
        return out


def _union_us(intervals: List[Tuple[float, float]]) -> float:
    busy = 0.0
    cur_s: Optional[float] = None
    cur_e = 0.0
    for s, e in sorted(intervals):
        if cur_s is None:
            cur_s, cur_e = s, e
        elif s <= cur_e:
            cur_e = max(cur_e, e)
        else:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
    if cur_s is not None:
        busy += cur_e - cur_s
    return busy


def summarize_trace(prof: "object", plane: str = "cuda") -> TraceReport:
    """Device rows of a finished ``torch.profiler.profile`` (``plane="cuda"``), or its CPU operators (``"cpu"``).

    Device rows are the events the profiler attributes to a CUDA device,
    the pre-roll's fills left out; CPU rows are the top-level operators
    (no parent), so nested operators are not counted twice.
    """
    totals: Dict[str, List[float]] = {}
    intervals: List[Tuple[float, float]] = []
    for ev in prof.events():
        on_device = str(getattr(ev, "device_type", "")).endswith("CUDA")
        if plane == "cpu":
            if on_device or getattr(ev, "cpu_parent", None) is not None:
                continue
        elif not on_device or PRE_ROLL_KERNEL in ev.name:
            continue
        start, end = float(ev.time_range.start), float(ev.time_range.end)
        row = totals.setdefault(ev.name, [0.0, 0])
        row[0] += end - start
        row[1] += 1
        intervals.append((start, end))
    summed = sum(us for us, _ in totals.values())
    ops = [
        OpTime(name=name, total_ms=us / 1e3, share=(us / summed if summed else 0.0), count=int(count))
        for name, (us, count) in sorted(totals.items(), key=lambda kv: -kv[1][0])
    ]
    return TraceReport(plane=plane, busy_ms=_union_us(intervals) / 1e3, summed_ms=summed / 1e3, ops=ops)


def profile_call(
    fn: Callable[[], object],
    tries: int = 4,
    complete: Optional[Callable[[TraceReport], bool]] = None,
) -> TraceReport:
    """Trace one call of ``fn`` and summarize it (see the module's recipe).

    Where CUDA is available the report holds the device rows, on the card
    ``fn`` ran on (``"cuda:<index>"``); without CUDA it holds the CPU
    operators. A trace without rows, or one that ``complete`` (given the
    report) rejects, is taken again with a pause, and after ``tries`` such
    traces it raises :class:`RuntimeError`.
    """
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    if cuda:
        pre = torch.empty(1, dtype=torch.float64, device="cuda")
    for attempt in range(tries):
        if cuda:
            torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]) as prof:
            if cuda:
                for _ in range(PRE_ROLL):
                    pre.fill_(0.0)
                torch.cuda.synchronize()
            fn()
            if cuda:
                torch.cuda.synchronize()
        report = summarize_trace(prof, plane=f"cuda:{torch.cuda.current_device()}" if cuda else "cpu")
        if report.ops and (complete is None or complete(report)):
            return report
        time.sleep(attempt + 1.0)
    raise RuntimeError(f"torch.profiler returned no complete trace in {tries} tries")


# -- the host tracer --------------------------------------------------------------------------
TRACER: Optional["Trace"] = None  # the trace that records, while a caller has tracing on
_CALL_IDS = itertools.count()  # call ids, unique within the process
_now = time.perf_counter_ns


@dataclasses.dataclass(eq=False, slots=True)
class Span:
    """One span: ``start_ns`` / ``end_ns`` on ``time.perf_counter_ns``, ``end_ns`` None while open.

    ``index`` numbers the spans of a trace in the order they opened,
    ``parent`` is the enclosing span's index (-1 for a root) and ``call``
    the id of the public call the span belongs to (-1 for none). ``note``
    qualifies a name (a ``graph.capture``'s ``"segment"`` or ``"finalize"``).
    """

    name: str
    start_ns: int
    end_ns: Optional[int]
    parent: int
    call: int
    index: int
    note: str = ""

    @property
    def seconds(self) -> float:
        return ((self.end_ns or self.start_ns) - self.start_ns) * 1e-9


def _launches() -> Dict[str, int]:
    from ..ops import kernel_wrappers

    return {f"launches.{fn.__name__}": fn.launches for fn in kernel_wrappers()}


class Trace:
    """The spans and counters recorded while tracing is on (:func:`tracing`).

    :attr:`spans` holds the spans since the last :meth:`drain`, open ones
    included; :meth:`counters` the counters since then, with the kernel
    wrappers' ``launches`` counted in, as ``launches.<wrapper>``.
    """

    def __init__(self) -> None:
        self.spans: List[Span] = []
        self._counts: Dict[str, int] = {}
        self._open: List[Span] = []  # the open spans, innermost last
        self._stage: Optional[Span] = None  # the stage span opened last
        self._next = 0  # the next span's index
        self._launches0 = _launches()

    def _push(self, name: str, call: int, note: str, now: int) -> Span:
        open_ = self._open
        if open_:
            top = open_[-1]
            span = Span(name, now, None, top.index, top.call, self._next, note)
        else:
            span = Span(name, now, None, -1, call, self._next, note)
        self._next += 1
        self.spans.append(span)
        open_.append(span)
        return span

    def span(self, name: str, note: str = "") -> Span:
        """A span inside the innermost open span (a root of no call where none is open)."""
        return self._push(name, -1, note, _now())

    def stage(self, name: str) -> None:
        """End the stage open in the innermost span and open stage ``name`` there, at one clock reading.

        A stage still open under the same name goes on; outside a call, nothing.
        """
        open_ = self._open
        if not open_:
            return
        now = _now()
        stage = self._stage
        if open_[-1] is stage:
            if stage.name == name:
                return
            stage.end_ns = now
            open_.pop()
        self._stage = self._push(name, -1, "", now)

    def end(self, span: Span) -> None:
        """End ``span`` now, and every span still open inside it."""
        now = _now()
        open_ = self._open
        for i in range(len(open_) - 1, -1, -1):
            if open_[i] is span:
                for inner in open_[i + 1:]:
                    inner.end_ns = now
                del open_[i:]
                break
        span.end_ns = now

    def count(self, name: str, n: int = 1) -> None:
        self._counts[name] = self._counts.get(name, 0) + n

    def counters(self) -> Dict[str, int]:
        out = dict(self._counts)
        out.update({key: n - self._launches0.get(key, 0) for key, n in _launches().items()})
        return out

    def drain(self) -> Tuple[List[Span], Dict[str, int]]:
        """The spans and counters since the last drain; the trace goes on from empty."""
        spans, counters = self.spans, self.counters()
        self.spans, self._counts, self._launches0 = [], {}, _launches()
        return spans, counters


@contextlib.contextmanager
def tracing() -> Iterator[Trace]:
    """Record spans and counters of the package's calls inside the block, into the trace it yields."""
    global TRACER
    prev, TRACER = TRACER, Trace()
    try:
        yield TRACER
    finally:
        TRACER = prev


class _Root:
    """A public call's root span as a context (:func:`call`, :func:`resume`); it yields the span.

    Inside another call it opens nothing and yields None: the inner call's
    stages go under the outer call's root.
    """

    def __init__(self, trace: Trace, name: str, call: int, span: Optional[Span] = None) -> None:
        self.trace, self.name, self.call, self.span = trace, name, call, span
        self.opened: Optional[Span] = None

    def __enter__(self) -> Optional[Span]:
        tr = self.trace
        if tr._open:
            return None
        if self.span is None:
            self.opened = tr._push(self.name, next(_CALL_IDS) if self.call < 0 else self.call, "", _now())
        else:
            tr._open.append(self.span)
            self.opened = self.span
        return self.opened

    def __exit__(self, *exc) -> None:
        if self.opened is not None:
            self.trace.end(self.opened)


_OFF = contextlib.nullcontext()


def call(name: str, call_id: int = -1):
    """A root span around a public call (call id ``call_id``, -1: a new one), or nothing when off."""
    tr = TRACER
    return _OFF if tr is None else _Root(tr, name, call_id)


def resume(span: Optional[Span]):
    """Reopen a call's root (a pipelined batch's, launched before): its later stages go under it."""
    tr = TRACER
    return _OFF if tr is None or span is None else _Root(tr, span.name, span.call, span)


def stage(name: str) -> None:
    """The next stage of the open call (:meth:`Trace.stage`); nothing when off."""
    tr = TRACER
    if tr is not None:
        tr.stage(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to a counter; nothing when off."""
    tr = TRACER
    if tr is not None:
        tr.count(name, n)
