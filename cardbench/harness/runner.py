"""One run of one cell: set-up, warm-up, the measured window, the trace, the check, the result line.

:func:`run_cell` does everything but look for a chip, so that a test can
drive a whole run on the CPU at a small size (``device="cpu"``).
:func:`main` is the command's entry point: it looks for the chips the cell
asks for first and exits without a result where they are not there.
"""
from __future__ import annotations

import argparse
import gc
import hashlib
import json
import os
import statistics
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

from . import judge, manifest, traffic
from .loops import BatchLoop, Sample, Spans, StreamLoop
from .trace import WINDOW
from .work import trie_letters
from ..reference.decoder import normalize_labels

FORBIDDEN = ("jax", "jaxlib", "flax", "pyctcdecode_tpu")
PROGRAM = "pyctcdecode_torch"
CACHE_DIR = manifest.BENCH_DIR / ".cache"  # the LM's ARPA text, written by a checkout's first run


def log(msg: str) -> None:
    print(f"cardbench: {msg}", file=sys.stderr, flush=True)


def lm_files(recipe: Dict, cache_dir: Path) -> Dict[str, Path]:
    """The configuration's LM files, written once into ``cache_dir`` by the module its ``kind`` names.

    ``cardbench/lms/<kind>.py`` gives ``files(recipe, cache_dir, key)``: the
    file the program loads (``load``), the ARPA text the reference reads
    (``arpa``) and the LM's word list (``words``). The key holds every
    number of the recipe, so another recipe writes other files. A kind with
    no module is refused.
    """
    kind = recipe["kind"]
    try:
        module = manifest.module("lms", kind)
    except LookupError:
        raise ValueError(f"unknown LM kind {kind!r}: no cardbench/lms/{kind}.py") from None
    key = f"{kind}-{hashlib.sha256(json.dumps(recipe, sort_keys=True).encode()).hexdigest()[:16]}"
    t0 = time.perf_counter()
    files = module.files(recipe, cache_dir, key)
    log(f"LM files {key} ready in {time.perf_counter() - t0:.1f} s")
    return files


def forbidden_modules() -> List[str]:
    return sorted({name.split(".", 1)[0] for name in sys.modules} & set(FORBIDDEN))


def _device_info(torch, device: str) -> Dict:
    if device == "cuda":
        return dict(platform="gpu", kind=torch.cuda.get_device_name(0), count=1,
                    memory_peak_bytes=int(torch.cuda.max_memory_allocated()))
    return dict(platform="cpu", kind="cpu", count=1, memory_peak_bytes=0)


def _trace(torch, device: str, spans: Spans, body):
    """Run ``body`` under the profiler (CUDA activity only); the device rows and the host offset."""
    from torch.profiler import ProfilerActivity, profile

    from .trace import PRE_ROLL, events, host_offset

    if device != "cuda":  # no device rows to read: the spans alone
        with spans(WINDOW):
            out = body()
        return out, [], 0.0
    pre = torch.empty(1, dtype=torch.float64, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PRE_ROLL):
            pre.fill_(0.0)
        torch.cuda.synchronize()
        mark = time.perf_counter()
        pre.fill_(0.0)
        torch.cuda.synchronize()
        with spans(WINDOW):
            out = body()
        torch.cuda.synchronize()
    rows = events(prof)
    offset = host_offset(rows, mark)
    if offset is None:  # the fills were dropped: the trace's clock is the wall clock
        offset = time.time() - time.perf_counter()
        log("trace: no pre-roll fill in the trace; aligned the spans by the wall clock")
    return out, rows, offset


class Cell:
    """A cell's pieces and its decoder: what every run of the cell builds once, in set-up.

    ``decoder`` is built as users build it (``build_ctcdecoder`` over the
    configuration's labels and ARPA file); :meth:`loop` makes a seed's
    traffic and warms up its shapes; :meth:`judge` compares answers with the
    reference's.
    """

    def __init__(self, bench: Dict, cell_name: str, device: str, cache_dir: Path = CACHE_DIR) -> None:
        import pyctcdecode_torch as P

        entry = manifest.cell(bench, cell_name)
        self.cfg = cfg = manifest.config(bench, entry["config"])
        self.mix = manifest.mix(entry["traffic"])
        self.limits = manifest.limits(cell_name)
        self.search = dict(cfg["search"])
        self.files = lm_files(cfg["lm"], cache_dir)
        lm_words = self.files["words"].read_text(encoding="utf-8").split("\n")[:-1]
        self.labels = cfg["labels"]  # as the model gives them; the logits' columns are the normalized labels
        self.columns, self.is_bpe = normalize_labels(self.labels)
        t0 = time.perf_counter()
        self.decoder = P.build_ctcdecoder(self.labels, str(self.files["load"]), device=device, **cfg["decoder"])
        self.lm_build_s = time.perf_counter() - t0
        self.ctx = traffic.context(traffic.corpus_words(cfg, lm_words), self.columns, self.is_bpe, cfg["frame_s"])
        self.kind: Optional[str] = None  # the loop the traffic asks for, known once it is made
        self.chunk_frames: Optional[int] = None
        self._model = None  # the reference's ARPA model, read at the first check

    def loop(self, seed: int, spans: Spans):
        """The seed's traffic in its loop, after a warm-up of its shapes; and the inputs."""
        mix, search = self.mix, self.search
        made = traffic.make(mix, seed, self.ctx)
        self.kind = made["kind"]
        if self.kind == "batch":
            pool = made["pool"]
            call_kw = dict(search, **mix.get("decode", {}))
            # every batch has the same sizes, so one call takes every capture
            BatchLoop(self.decoder, pool, call_kw, Spans(), Sample(1, traffic.seeded(0))).call()
            return BatchLoop(self.decoder, pool, call_kw, spans, Sample(mix["check"], traffic.seeded(seed, 3))), pool
        self.chunk_frames = made["chunk_frames"]
        start_kw = dict(beam_width=search["beam_width"])
        call_kw = {k: v for k, v in search.items() if k != "beam_width"}
        # one utterance streamed whole takes the chunk's and both finalizes' captures
        state = self.decoder.get_starting_state(**start_kw)
        warm = traffic.chunks(made["streams"][0]["utterances"][0], self.chunk_frames)
        for i, chunk in enumerate(warm):
            self.decoder.partial_decode_beams(state, chunk, is_end=i == len(warm) - 1, **call_kw)
        sample = Sample(mix["check"], traffic.seeded(seed, 4))
        inputs = [st["utterances"] for st in made["streams"]]
        return StreamLoop(self.decoder, made, start_kw, call_kw, spans, sample), inputs

    @staticmethod
    def answers(loop):
        """Attempted and failed counts, and the sample of answers to judge: (input key, answer)."""
        if isinstance(loop, BatchLoop):
            return loop.attempted, loop.failed, loop.sample.picks()
        return len(loop.served), sum(1 for c in loop.served if c["failed"]), loop.sample.picks()

    def reference(self, precision: str = "f64"):
        """The reference decoder at ``precision`` over its own read of the ARPA file."""
        from ..reference.arpa import ArpaModel
        from ..reference.decoder import ReferenceDecoder

        if self._model is None:
            t0 = time.perf_counter()
            self._model = ArpaModel.cached(str(self.files["arpa"]))
            log(f"reference: ARPA read in {time.perf_counter() - t0:.1f} s")
        dec = self.cfg["decoder"]
        return ReferenceDecoder(self.labels, self._model, alpha=dec["alpha"], beta=dec["beta"],
                                unk_score_offset=dec["unk_score_offset"], score_boundary=dec["lm_score_boundary"],
                                precision=precision)

    def reference_answer(self, ref, inputs, key) -> List:
        """The reference's answer for one input: an utterance's beams, or a stream's views."""
        s = self.search
        kw = dict(beam_width=s["beam_width"], prune_logp=s["beam_prune_logp"], token_min_logp=s["token_min_logp"])
        a, b = key
        if self.kind == "batch":
            return ref.decode(inputs[a][b], **kw)
        utt = inputs[a][b % len(inputs[a])]
        return [judge.reference_view(v) for v in ref.stream(traffic.chunks(utt, self.chunk_frames), **kw)]

    def pairs(self, got_by_key, want_by_key) -> List:
        """(program answer, reference answer) pairs: a batch answer each, a stream's views each."""
        out = []
        for key, got in got_by_key:
            want = want_by_key[key]
            if self.kind == "batch":
                out.append((got, want))
            else:
                views = list(got) + [None] * (len(want) - len(got))
                out.extend(zip(views, want))
        return out

    def judge(self, answers, inputs, ref) -> Dict[str, float]:
        """The numbers compared, over the program's ``answers`` against ``ref``'s."""
        t0 = time.perf_counter()
        words = self._model.words
        want = {}
        got = []
        for key, ans in answers:
            if key not in want:
                want[key] = self.reference_answer(ref, inputs, key)
            if self.kind == "batch":
                got.append((key, judge.program_output(ans, words) if ans else None))
            else:
                got.append((key, [judge.program_view(v) if v else None for v in ans]))
        numbers = judge.compare(self.pairs(got, want))
        log(f"reference: {len(want)} inputs decoded and judged in {time.perf_counter() - t0:.1f} s")
        return numbers


def run_cell(bench: Dict, cell_name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t_start: Optional[float] = None, cache_dir: Path = CACHE_DIR) -> Dict:
    """One run of ``cell_name``; returns the result line's object (``compared`` last)."""
    t_start = time.perf_counter() if t_start is None else t_start
    import torch

    cell = Cell(bench, cell_name, device, cache_dir)
    mix, cfg = cell.mix, cell.cfg
    spans = Spans()
    loop, inputs = cell.loop(seed, spans)
    if device == "cuda":
        torch.cuda.synchronize()
    spans.items.clear()
    rec: Dict = dict(kind=cell.kind, lm_build_s=cell.lm_build_s, trace=None,
                     setup_s=time.perf_counter() - t_start)
    log(f"set-up {rec['setup_s']:.2f} s: build_ctcdecoder {cell.lm_build_s:.2f} s")

    # the measured window
    if cell.kind == "batch":
        window = loop.run(seconds)
        frames = sum(c["frames"] for c in window["calls"])  # the audio of the utterances answered
        rec["window"] = dict(start=window["start"], end=window["end"], audio_s=frames * cfg["frame_s"],
                             calls=len(window["calls"]))
        took = [c["t1"] - c["t0"] for c in window["calls"]]
        half = len(took) // 2
        log(f"window: {len(took)} calls, {rec['window']['audio_s']:.1f} audio-s in "
            f"{window['end'] - window['start']:.3f} s; a call's median s, first half "
            f"{statistics.median(took[:half] or took):.4f}, second half {statistics.median(took[half:]):.4f}")
    else:
        loop.open()
        w0 = time.perf_counter()
        loop.schedule(w0)
        served = loop.serve_until(w0 + seconds)
        rec["window"] = dict(start=w0, end=w0 + seconds, chunks=len(served))
        # a failed chunk is missing: counted in ``failed`` (and the run not correct), not as a latency
        rec["latency_ms"] = [(c["end"] - c["due"]) * 1e3 for c in served if not c["failed"]]
        rec["service_ms"] = [(c["end"] - c["start"]) * 1e3 for c in served if not c["failed"]]
        log(f"window: {len(served)} chunks served, {loop.finished} utterances finished")
    rec["spans"] = list(spans.items)

    # the traced window, after the measured one
    breakdown = None
    if trace:
        from .trace import summarize

        first = len(spans.items)
        if cell.kind == "batch":
            calls = mix["trace_calls"]
            traced, rows, offset = _trace(torch, device, spans, lambda: [loop.call() for _ in range(calls)])
        else:
            def stretch():  # the streams' own pace: the chunks that fell due while the profiler started, moved on
                log(f"trace: due times moved {loop.shift_to(time.perf_counter()) * 1e3:.1f} ms later")
                return loop.serve_until(time.perf_counter() + mix["trace_s"])

            traced, rows, offset = _trace(torch, device, spans, stretch)
        t_read = time.perf_counter()
        ranges = [(name, a + offset, b + offset) for name, a, b in spans.items[first:]]
        summary = summarize(rows, ranges)
        del rows, ranges
        log(f"trace read in {time.perf_counter() - t_read:.1f} s")
        if summary is not None:
            rec["trace"] = summary
            breakdown = dict(device_ops=summary["device_ops"], idle_gaps=summary["idle_gaps"])
        if cell.kind == "batch":
            counts = [[m.shape[0] for m in inputs[c["batch"]]] for c in traced]
            rec["traced"] = dict(calls=len(traced), steps=sum(max(c) for c in counts),
                                 row_steps=sum(sum(c) for c in counts))
        else:
            rec["traced"] = dict(chunks=len(traced))
        rec["shape"] = dict(vocab=len(cell.columns), beam=cell.search["beam_width"],
                            letters=trie_letters(cell.columns, cell.is_bpe), order=cfg["lm"]["order"])

    device_info = _device_info(torch, device)
    rec["peak_bytes"] = device_info["memory_peak_bytes"]

    # the answers to judge, as the program gave them; then the program's state is freed
    attempted, failed, answers = cell.answers(loop)
    del loop
    cell.decoder = None
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    numbers = cell.judge(answers, inputs, cell.reference("f64"))
    correct = judge.verdict(numbers, cell.limits) and bool(answers) and failed == 0
    if not answers:
        log("no answer finished in the window: nothing could be judged")
    if failed:
        log(f"{failed} of {attempted} answers failed: not correct")

    section = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in manifest.metrics_of(bench, section, cell_name):
        value = manifest.reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = dict(value=value, unit=m["unit"])
    if trace and rec["trace"] is not None:
        device_info["busy_s"] = rec["trace"]["busy_s"]
        device_info["window_s"] = rec["trace"]["window_s"]
    result = dict(correct=bool(correct), attempted=attempted, failed=failed, metrics=metrics, device=device_info)
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["compared"] = {name: dict(value=numbers[name], limit=cell.limits[name]) for name in cell.limits}
    return result


def main(argv: Optional[Sequence[str]] = None, t_start: Optional[float] = None) -> int:
    parser = argparse.ArgumentParser(description="Run one benchmark cell of pyctcdecode_torch on CUDA.")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    bench = manifest.manifest()
    cell = manifest.cell(bench, args.workload)

    import torch

    if not torch.cuda.is_available():
        log("torch.cuda.is_available() is False: no CUDA device, no result")
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        log(f"{torch.cuda.device_count()} CUDA devices, the cell asks for {cell['chips']}: no result")
        return 2
    import pyctcdecode_torch

    where = Path(pyctcdecode_torch.__file__).resolve()
    if manifest.ROOT not in where.parents:
        log(f"{PROGRAM} was imported from {where}, not from this checkout: no result")
        return 2
    result = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace), "cuda", t_start)
    found = forbidden_modules()
    if found:
        log(f"modules of JAX or the JAX package were loaded: {found}; no result")
        return 3
    for name, c in result["compared"].items():
        log(f"{name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0
