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
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

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
