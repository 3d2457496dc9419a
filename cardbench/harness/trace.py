"""Reading a ``torch.profiler`` trace: device busy time, idle gaps and what the host was doing.

The arithmetic is that of ``pyctcdecode_torch.utils.profiling`` (device
rows, busy time as the union of their intervals, totals by name, CUDA
activity only so that the host runs at its own speed, and a pre-roll of
tiny float64 fills so that a trace that drops its first kernels drops
those), with the window and the gaps added. The harness's spans are
host-clock intervals; the last pre-roll fill, launched right after a
synchronize at a known host time, puts them on the trace's clock. The
traced window is the harness's ``traced_window`` span, the device rows are
clipped to it, and each idle gap is named by the harness span that was
open at the gap's middle.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

WINDOW = "traced_window"
PRE_ROLL = 64
PRE_ROLL_KERNEL = "FillFunctor<double>"  # the pre-roll's kernel (a decode fills no float64 tensor)
SHORT_GAP_S = 20e-6  # gaps under this are the launch gaps between a graph's kernels

Interval = Tuple[float, float]


def union(intervals: Sequence[Interval]) -> List[Interval]:
    """The union of ``intervals`` as sorted, disjoint intervals."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _seconds(ev) -> Tuple[float, float]:
    if hasattr(ev, "start_ns"):
        start = ev.start_ns()
        return start * 1e-9, (start + ev.duration_ns()) * 1e-9
    start = ev.start_us()
    return start * 1e-6, (start + ev.duration_us()) * 1e-6


def events(prof) -> List[Tuple[str, float, float]]:
    """The device rows (kernels, memsets, copies) of a finished profile, in seconds on the trace's clock."""
    rows = []
    for ev in prof.profiler.kineto_results.events():
        if str(ev.device_type()).endswith("CUDA"):
            rows.append((ev.name(), *_seconds(ev)))
    return rows


def host_offset(rows, mark: float) -> Optional[float]:
    """Trace clock minus host clock: the last pre-roll fill started at host time ``mark`` (None: no fill)."""
    fills = [s for name, s, _ in rows if PRE_ROLL_KERNEL in name]
    return max(fills) - mark if fills else None


def summarize(rows, ranges, top: int = 10) -> Dict:
    """Busy and window seconds, device rows, the top ops and the idle time by open span.

    ``rows`` and ``ranges`` are ``(name, start_s, end_s)``; the window is the
    first range named :data:`WINDOW`. Returns ``None`` without one.
    """
    window = next(((s, e) for name, s, e in ranges if name == WINDOW), None)
    if window is None:
        return None
    w0, w1 = window
    clipped = [(n, max(s, w0), min(e, w1)) for n, s, e in rows if e > w0 and s < w1 and PRE_ROLL_KERNEL not in n]
    busy = union([(s, e) for _, s, e in clipped])
    busy_s = sum(e - s for s, e in busy)
    totals: Dict[str, List[float]] = {}
    for name, s, e in clipped:
        t = totals.setdefault(name, [0.0, 0])
        t[0] += e - s
        t[1] += 1
    ops = sorted(totals.items(), key=lambda kv: -kv[1][0])
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    starts, ends = np.asarray(edges[0::2]), np.asarray(edges[1::2])
    keep = ends > starts
    starts, ends = starts[keep], ends[keep]
    mids, lengths = (starts + ends) / 2, ends - starts
    labels = np.full(len(mids), "harness", dtype=object)
    for name, s, e in ranges:
        if name != WINDOW:
            lo, hi = np.searchsorted(mids, s), np.searchsorted(mids, e)
            labels[lo:hi] = name
    idle: Dict[str, float] = {}
    for label, length in zip(labels, lengths):
        key = f"{label} {'<' if length < SHORT_GAP_S else '>='}20us"
        idle[key] = idle.get(key, 0.0) + float(length)
    return dict(
        busy_s=busy_s,
        window_s=w1 - w0,
        device_rows=len(clipped),
        ops=[[name, t[0], int(t[1])] for name, t in ops],
        device_ops=[[name, t[0]] for name, t in ops[:top]],
        idle_gaps=sorted(([k, v] for k, v in idle.items()), key=lambda kv: -kv[1])[:top],
    )
