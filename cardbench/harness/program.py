"""The program's own spans and counters in a run's record (``pyctcdecode_torch.utils.profiling``).

A run with the program's tracer on drains it at the end of each phase
(:data:`PHASES`: set-up, the measured window, the traced stretch) into
``rec["program"][phase]``: its spans, each a dict of ``name``, ``start``
and ``end`` (seconds on ``time.perf_counter``, the clock of the harness's
own spans), ``parent`` and ``index`` (the enclosing span's index, -1 for a
root), ``call`` (the public call's id) and ``note``; and its counters.

:func:`ranges` puts the traced stretch's spans beside the harness's for
``trace.summarize``, which names an idle gap by the last range open at its
middle: ordered from the outermost span in, a gap inside a program span
reads ``<harness span>/<program span>`` (``decode_beams_batch/batch.replay``),
and a gap under no program span keeps the harness span's name.

The readers of the per-layer metrics that come from these spans and
counters use :func:`call_stages` and :func:`fill`; each returns None where
a record holds no program spans (a run with the tracer off, or a program
without it).
"""
from __future__ import annotations

import statistics
from typing import Dict, List, Optional, Sequence, Tuple

from .trace import WINDOW

PHASES = ("setup", "window", "traced")


def drain(trace) -> Dict:
    """The spans (closed ones) and counters the tracer recorded since its last drain, as plain data."""
    spans, counters = trace.drain()
    return dict(spans=[dict(name=s.name, start=s.start_ns * 1e-9, end=s.end_ns * 1e-9, parent=s.parent,
                            index=s.index, call=s.call, note=s.note) for s in spans if s.end_ns is not None],
                counters=counters)


def _depth(spans: Sequence[Dict]) -> Dict[int, int]:
    by_index = {s["index"]: s for s in spans}
    depth: Dict[int, int] = {}
    for s in spans:
        d, p = 0, s["parent"]
        while p in by_index:
            d, p = d + 1, by_index[p]["parent"]
        depth[s["index"]] = d
    return depth


def ranges(phase: Dict, offset: float, harness: Sequence[Tuple[str, float, float]]) -> List[Tuple[str, float, float]]:
    """The phase's program spans as ``(name, start, end)`` on the trace's clock (``+ offset``), outermost first.

    ``harness``: the harness's ranges on that clock; a program span takes
    the name of the harness span its middle lies in (the traced window
    aside) before its own, ``<harness>/<program>``, or its own alone.
    """
    outer = [(name, s, e) for name, s, e in harness if name != WINDOW]
    depth = _depth(phase["spans"])
    out = []
    for s in sorted(phase["spans"], key=lambda s: depth[s["index"]]):
        a, b = s["start"] + offset, s["end"] + offset
        mid = (a + b) / 2
        host = next((name for name, hs, he in reversed(outer) if hs <= mid <= he), None)
        out.append((s["name"] if host is None else f"{host}/{s['name']}", a, b))
    return out


def _phase(rec: Dict, phase: str) -> Optional[Dict]:
    program = rec.get("program")
    return None if not program else program.get(phase)


def call_stages(rec: Dict, phase: str, root: str, stages: Sequence[str]) -> Optional[List[float]]:
    """Seconds of ``stages`` summed inside each ``root`` span of ``phase``, one a root; None without any."""
    p = _phase(rec, phase)
    if p is None:
        return None
    roots = {s["index"]: 0.0 for s in p["spans"] if s["name"] == root and s["parent"] < 0}
    for s in p["spans"]:
        if s["parent"] in roots and s["name"] in stages:
            roots[s["parent"]] += s["end"] - s["start"]
    return list(roots.values()) or None


def median_ms(rec: Dict, root: str, stages: Sequence[str]) -> Optional[float]:
    """The median over the window's ``root`` spans of their ``stages``' summed time, in ms."""
    per_call = call_stages(rec, "window", root, stages)
    return None if per_call is None else statistics.median(per_call) * 1e3


def fill(rec: Dict, kind: str) -> Optional[float]:
    """The window's ``steps.active`` over ``steps.launched`` in a ``kind`` run; None without them."""
    p = _phase(rec, "window")
    if rec["kind"] != kind or p is None or not p["counters"].get("steps.launched"):
        return None
    return p["counters"].get("steps.active", 0) / p["counters"]["steps.launched"]


def setup_seconds(rec: Dict, stages: Sequence[str]) -> Optional[float]:
    """Seconds of the set-up's ``stages`` under its ``build`` roots; None without a build root or a stage.

    An ensemble's members are read and built outside ``build_ctcdecoder``,
    under no program span: its build root holds the device tables alone.
    """
    p = _phase(rec, "setup")
    if p is None or not set(stages) <= {s["name"] for s in p["spans"]}:
        return None
    per_build = call_stages(rec, "setup", "build", stages)
    return None if per_build is None else sum(per_build)
