"""A cell's run with the program's tracer on: where the host's time goes inside the calls.

    python3 cardbench/spans.py --workload <cell> --seed <n> --seconds <s> [--cost-calls N] [--cost-s S]

from the root of a checkout. One process runs the cell as ``run.py
--trace 1`` does (set-up, the measured window, the traced stretch under the
profiler) with the program's tracer
(``pyctcdecode_torch.utils.profiling.tracing``) on from before
``build_ctcdecoder`` to the end of the stretch, drained at the end of each
phase into ``rec["program"]`` (``harness/program.py``). Then it measures
what the tracer costs, and prints one JSON line:

* ``metrics``: the cell's per-layer metrics of ``BENCHMARK.json`` and the
  readers of :data:`PROGRAM_METRICS`, which read the program's spans;
* ``tiling``: over the window's calls, the program's stages summed inside a
  call's root, and the root itself, over the harness's span around the call
  (median, least, most);
* ``stage_ms``: each stage's median ms over the calls of the window and of
  the traced stretch (where the profiler slows the host);
* ``steps``: the traced calls' ``steps.active`` and the row-steps their
  inputs need by the harness's own count;
* ``idle_gaps``: the traced stretch's idle time by the harness's spans
  alone (as ``run.py`` names it) and by the innermost span open, the
  program's included; ``bare_share``, the share of the idle time inside the
  harness's call spans that no program span names;
* ``by_chunk`` (streams): the median ``chunk.backtrace`` + ``chunk.replay``
  ms by the chunk's index in its utterance;
* ``cost``: the window's calls once more, the tracer on and off in turns,
  call by call (each side's median and quartiles of a call's wall time),
  and the tracer's own sites a batch call or a chunk passes, timed alone
  with tracing on and off.

Nothing is judged: the line is not a result of the cell. Without CUDA it
exits with code 2, as ``run.py`` does; ``--device cpu`` runs it on the CPU
at whatever size the cell has (the tests give it a tiny cell).
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from cardbench.harness import manifest, program  # noqa: E402
from cardbench.harness.loops import Spans  # noqa: E402
from cardbench.harness.runner import (  # noqa: E402
    CACHE_DIR, Cell, _device_info, _trace, log, measure_window, traced_stretch)
from cardbench.harness.trace import summarize  # noqa: E402

PROGRAM_METRICS = ("lm_read_s", "lm_tables_s", "host_prep_ms.batch", "host_replay_ms.batch", "step_fill.batch",
                   "chunk_prep_ms.stream", "chunk_replay_ms.stream", "step_fill.stream")
CALLS = {"batch": ("decode_beams_batch", "batch"), "stream": ("partial_decode_beams", "chunk")}
SITE_REPS = 20_000


def _quartiles(values):
    if len(values) < 2:
        return dict(median=values[0] if values else None, q1=None, q3=None, n=len(values))
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return dict(median=q2, q1=q1, q3=q3, n=len(values))


def _chunk_frames(loop, served):
    return sum(loop.streams[c["stream"]][c["utt"] % len(loop.streams[c["stream"]])][c["chunk"]].shape[0]
               for c in served)


def _roots(rec, phase):
    root = CALLS[rec["kind"]][1]
    return [s for s in rec["program"][phase]["spans"] if s["name"] == root and s["parent"] < 0]


def tiling(rec, harness_spans):
    """The window's calls: stages summed and root, each over the harness's span around the call."""
    outer, root = CALLS[rec["kind"]]
    calls = [(a, b) for name, a, b in harness_spans if name == outer]
    roots = _roots(rec, "window")
    if len(roots) != len(calls):
        return dict(calls=len(calls), roots=len(roots))
    every_stage = {s["name"] for s in rec["program"]["window"]["spans"]}
    staged = program.call_stages(rec, "window", root, every_stage)
    stages = [t / (b - a) for t, (a, b) in zip(staged, calls)]
    whole = [(r["end"] - r["start"]) / (b - a) for r, (a, b) in zip(roots, calls)]
    return dict(calls=len(calls), stages_over_call=dict(median=statistics.median(stages), least=min(stages),
                                                        most=max(stages)),
                root_over_call=dict(median=statistics.median(whole), least=min(whole), most=max(whole)))


def stage_ms(rec, phase):
    """Each stage's median ms over the phase's call roots (a stage a root lacks counts 0 there)."""
    root = CALLS[rec["kind"]][1]
    spans = rec["program"][phase]["spans"]
    roots = {s["index"]: {} for s in spans if s["name"] == root and s["parent"] < 0}
    for s in spans:
        if s["parent"] in roots:
            per = roots[s["parent"]]
            per[s["name"]] = per.get(s["name"], 0.0) + (s["end"] - s["start"]) * 1e3
    names = sorted({name for per in roots.values() for name in per})
    return {name: statistics.median(per.get(name, 0.0) for per in roots.values()) for name in names}


def bare_share(gaps, kind):
    """The share of the idle time inside the harness's call spans left under the bare call name."""
    outer = CALLS[kind][0]
    inside = sum(v for k, v in gaps if k.split(" ")[0].split("/")[0] == outer)
    bare = sum(v for k, v in gaps if k.split(" ")[0] == outer)
    return bare / inside if inside else None


def by_chunk(rec):
    """Median ms of ``chunk.backtrace`` + ``chunk.replay`` by the chunk's index in its stream's utterance."""
    host = program.call_stages(rec, "window", "chunk", ("chunk.backtrace", "chunk.replay"))
    seen, out = {}, {}
    for r, seconds in zip(_roots(rec, "window"), host):
        i = seen[r["call"]] = seen.get(r["call"], -1) + 1
        out.setdefault(i, []).append(seconds * 1e3)
    return {i: statistics.median(v) for i, v in sorted(out.items())}


class _Toggle:
    """The decoder behind a loop, with the program's tracer on for every other call of ``method``."""

    def __init__(self, decoder, method, trace, profiling):
        self._decoder, self._method, self._trace, self._profiling = decoder, method, trace, profiling
        self.on = []

    def __getattr__(self, name):
        fn = getattr(self._decoder, name)
        if name != self._method:
            return fn

        def call(*args, **kwargs):
            on = len(self.on) % 2 == 1
            self.on.append(on)
            self._profiling.TRACER = self._trace if on else None
            try:
                return fn(*args, **kwargs)
            finally:
                self._profiling.TRACER = None

        return call


def _batch_sites(profiling):
    """The tracer sites one ``decode_beams_batch`` call (one group) passes, in order, with no work between."""
    with profiling.call("batch"):
        profiling.stage("batch.prep")  # _launch_batch
        profiling.stage("batch.prep")  # _dispatch_batch
        tr = profiling.TRACER  # _launch
        if tr is not None:
            tr.count("steps.active", 1)
            tr.count("steps.launched", 1)
            tr.stage("batch.upload")
        profiling.stage("batch.enqueue")
        profiling.count("graph.hits")  # _segment_graph
        profiling.count("graph.hits")  # _finalize_graph
        profiling.stage("batch.fetch")  # _collect_batch
        profiling.stage("batch.replay")


def _chunk_sites(profiling):
    """The tracer sites one ``partial_decode_beams`` call passes, in order, with no work between."""
    with profiling.call("chunk", 1):
        profiling.stage("chunk.prep")
        profiling.stage("chunk.upload")
        profiling.stage("chunk.enqueue")
        tr = profiling.TRACER  # the engine's chunk_fn
        if tr is not None:
            tr.count("steps.active", 1)
            tr.count("steps.launched", 1)
        profiling.count("graph.hits")  # _segment_graph
        profiling.count("graph.hits")  # _finalize_graph
        profiling.stage("chunk.fetch")
        profiling.stage("chunk.backtrace")
        profiling.stage("chunk.replay")


def site_cost_us(profiling, kind, reps=SITE_REPS):
    """Micro-seconds of the sites a call passes, with the tracer off and on (the spans drained every 1000)."""
    out = {}
    passes = _batch_sites if kind == "batch" else _chunk_sites
    for side in ("off", "on"):
        trace = profiling.Trace() if side == "on" else None
        took = 0.0
        for start in range(0, reps, 1000):
            profiling.TRACER = trace
            t0 = time.perf_counter()
            for _ in range(min(1000, reps - start)):
                passes(profiling)
            took += time.perf_counter() - t0
            profiling.TRACER = None
            if trace is not None:
                trace.drain()
        out[side] = took / reps * 1e6
    return out


def cost(cell, loop, profiling, calls, stream_s):
    """The window's calls again, tracer on and off in turns: each side's wall time a call, in ms."""
    trace = profiling.Trace()
    if cell.kind == "batch":
        toggle = _Toggle(cell.decoder, "decode_beams_batch", trace, profiling)
        loop.decoder = toggle
        done = [loop.call() for _ in range(calls)]
        took = [(c["t1"] - c["t0"]) * 1e3 for c in done]
    else:
        toggle = _Toggle(cell.decoder, "partial_decode_beams", trace, profiling)
        loop.decoder = toggle
        loop.shift_to(time.perf_counter())
        served = loop.serve_until(time.perf_counter() + stream_s)
        took = [(c["end"] - c["start"]) * 1e3 for c in served]
    loop.decoder = cell.decoder
    on = [t for t, flag in zip(took, toggle.on) if flag]
    off = [t for t, flag in zip(took, toggle.on) if not flag]
    return dict(on=_quartiles(on), off=_quartiles(off), sites_us=site_cost_us(profiling, cell.kind))


def same_outputs_on_and_off(cell, pool, profiling) -> bool:
    """A batch call's answers with the tracer on equal those with it off, to the bit."""
    kw = dict(cell.search, **cell.mix.get("decode", {}))
    off = cell.decoder.decode_beams_batch(pool[0], **kw)
    with profiling.tracing():
        on = cell.decoder.decode_beams_batch(pool[0], **kw)
    fields = ("text", "text_frames", "logit_score", "lm_score")
    return all([[getattr(b, f) for f in fields] for b in x] == [[getattr(b, f) for f in fields] for b in y]
               for x, y in zip(off, on))


def run(bench, cell_name, seed, seconds, device="cuda", cost_calls=40, cost_s=10.0, cache_dir=CACHE_DIR,
        t_start=None):
    """One traced run of ``cell_name`` with the program's tracer on; the line's object."""
    t_start = time.perf_counter() if t_start is None else t_start
    import torch

    from pyctcdecode_torch.utils import profiling

    with profiling.tracing() as tr:
        cell = Cell(bench, cell_name, device, cache_dir)
        spans = Spans()
        loop, inputs = cell.loop(seed, spans)
        if device == "cuda":
            torch.cuda.synchronize()
        spans.items.clear()
        rec = dict(kind=cell.kind, lm_build_s=cell.lm_build_s, trace=None, setup_s=time.perf_counter() - t_start)
        rec["program"] = dict(setup=program.drain(tr))
        measure_window(cell, loop, rec, seconds)
        rec["program"]["window"] = program.drain(tr)
        rec["spans"] = list(spans.items)
        first = len(spans.items)
        traced, rows, offset = _trace(torch, device, spans, lambda: traced_stretch(cell, loop))
        rec["program"]["traced"] = program.drain(tr)
    harness = [(name, a + offset, b + offset) for name, a, b in spans.items[first:]]
    rec["trace"] = summarize(rows, harness, top=10)
    named = summarize(rows, harness + program.ranges(rec["program"]["traced"], offset, harness), top=1000)
    plain = summarize(rows, harness, top=1000)
    del rows
    if cell.kind == "batch":
        counts = [[m.shape[0] for m in inputs[c["batch"]]] for c in traced]
        rec["traced"] = dict(calls=len(traced), steps=sum(max(c) for c in counts),
                             row_steps=sum(sum(c) for c in counts))
        needed = rec["traced"]["row_steps"]
    else:
        rec["traced"] = dict(chunks=len(traced))
        needed = _chunk_frames(loop, traced)
    rec["shape"] = cell.shape()
    rec["peak_bytes"] = _device_info(torch, device)["memory_peak_bytes"]
    names = [m["name"] for m in manifest.metrics_of(bench, "per_layer", cell_name)] + list(PROGRAM_METRICS)
    metrics = {name: manifest.reader(name)(rec) for name in names}
    out = dict(cell=cell_name, seed=seed, device=_device_info(torch, device)["kind"],
               metrics={k: v for k, v in metrics.items() if v is not None},
               tiling=tiling(rec, rec["spans"]),
               stage_ms={phase: stage_ms(rec, phase) for phase in ("window", "traced")},
               steps=dict(active=rec["program"]["traced"]["counters"].get("steps.active"), needed=needed,
                          launched=rec["program"]["traced"]["counters"].get("steps.launched")),
               counters={phase: rec["program"][phase]["counters"] for phase in ("window", "traced")},
               setup_spans={s["name"]: s["end"] - s["start"] for s in rec["program"]["setup"]["spans"]
                            if s["name"].startswith("build")},
               idle_gaps=dict(harness=plain["idle_gaps"][:12] if plain else None,
                              program=named["idle_gaps"][:16] if named else None),
               bare_share=bare_share(named["idle_gaps"], cell.kind) if named else None)
    if cell.kind == "stream":
        out["by_chunk"] = by_chunk(rec)
    else:
        out["same_outputs"] = same_outputs_on_and_off(cell, loop.pool, profiling)
    out["cost"] = cost(cell, loop, profiling, cost_calls, cost_s)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="A cell's run with the program's tracer on.")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--cost-calls", type=int, default=40, help="batch calls for the on/off cost")
    parser.add_argument("--cost-s", type=float, default=10.0, help="seconds of streams for the on/off cost")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args(argv)
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        log("torch.cuda.is_available() is False: no CUDA device, no result")
        return 2
    bench = manifest.manifest()
    out = run(bench, args.workload, args.seed, args.seconds, args.device, args.cost_calls, args.cost_s,
              t_start=T_START)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):  # where run.py puts them
        os.environ[var] = os.path.join(ROOT, "build", sub)
    sys.exit(main())
