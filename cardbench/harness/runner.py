"""One run of one cell: set-up, warm-up, the measured window, the trace, the check, the result line.

:func:`run_cell` does everything but look for a chip, so that a test can
drive a whole run on the CPU at a small size (``device="cpu"``).
:func:`main` is the command's entry point: it looks for the chips the cell
asks for first and exits without a result where they are not there.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import hashlib
import json
import os
import statistics
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

from . import judge, manifest, program, traffic
from .loops import BatchLoop, Sample, Spans, StreamLoop
from .trace import WINDOW
from .work import trie_letters
from ..reference.decoder import normalize_labels

FORBIDDEN = ("jax", "jaxlib", "flax", "pyctcdecode_tpu")
PROGRAM = "pyctcdecode_torch"
HOTWORD_KEYS = ("hotwords", "hotword_weight")  # a mix's ``decode`` keys that the reference honours too
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


def _program_tracer(trace: bool):
    """The program's own tracer (``pyctcdecode_torch.utils.profiling.tracing``) where ``trace``, else nothing."""
    if not trace:
        return contextlib.nullcontext()
    from pyctcdecode_torch.utils import profiling

    return profiling.tracing()


class Cell:
    """A cell's pieces and its decoder: what every run of the cell builds once, in set-up.

    ``decoder`` is built as users build it: ``build_ctcdecoder`` over the
    configuration's labels and LM file, or for an ensemble (the
    configuration's ``members``) one ``LanguageModel`` a member in a
    ``MultiLanguageModel`` (:meth:`build`); :meth:`loop` makes a seed's
    traffic and warms up its shapes; :meth:`judge` compares answers with the
    reference's.
    """

    def __init__(self, bench: Dict, cell_name: str, device: str, cache_dir: Path = CACHE_DIR) -> None:
        entry = manifest.cell(bench, cell_name)
        self.cfg = cfg = manifest.config(bench, entry["config"])
        self.mix = manifest.mix(entry["traffic"])
        self.limits = manifest.limits(cell_name)
        self.search = dict(cfg["search"])
        decode = self.mix.get("decode", {})
        self.hot = {k: decode[k] for k in HOTWORD_KEYS if k in decode}
        self.members = manifest.lm_members(cfg)
        self.member_files = [lm_files(recipe, cache_dir) for recipe, _ in self.members]
        lm_words = self.member_files[0]["words"].read_text(encoding="utf-8").split("\n")[:-1]
        self.labels = cfg["labels"]  # as the model gives them; the logits' columns are the normalized labels
        self.columns, self.is_bpe = normalize_labels(self.labels)
        t0 = time.perf_counter()
        self.decoder = self.build(device=device)
        self.lm_build_s = time.perf_counter() - t0
        self.ctx = traffic.context(traffic.corpus_words(cfg, lm_words), self.columns, self.is_bpe, cfg["frame_s"])
        self.kind: Optional[str] = None  # the loop the traffic asks for, known once it is made
        self.chunk_frames: Optional[int] = None
        self._models: Optional[List] = None  # the reference's ARPA models, read at the first check

    def build(self, **kw):
        """The program's decoder over the configuration's LM or ensemble (``kw``: ``device=`` or ``engine=``)."""
        import pyctcdecode_torch as P

        if "members" not in self.cfg:
            return P.build_ctcdecoder(self.labels, str(self.member_files[0]["load"]), **kw, **self.cfg["decoder"])
        from pyctcdecode_torch.models.ngram import load_unigram_set_from_arpa, open_ngram_file

        lms = [P.LanguageModel(open_ngram_file(str(files["load"])), load_unigram_set_from_arpa(str(files["arpa"])),
                               alpha=w["alpha"], beta=w["beta"], unk_score_offset=w["unk_score_offset"],
                               score_boundary=w["lm_score_boundary"])
               for (_, w), files in zip(self.members, self.member_files)]
        alphabet, ensemble = P.Alphabet.build_alphabet(self.labels), P.MultiLanguageModel(lms)
        if kw.get("engine") == "host":
            return P.BeamSearchDecoderCTC(alphabet, ensemble)
        return P.TorchBeamSearchDecoderCTC(alphabet, ensemble, device=kw["device"])

    def shape(self) -> Dict:
        """The step's shape for the yardstick (``harness.work.row_step``)."""
        return dict(vocab=len(self.columns), beam=self.search["beam_width"],
                    letters=trie_letters(self.columns, self.is_bpe),
                    orders=[recipe["order"] for recipe, _ in self.members],
                    hotwords=any(p.split() for p in self.hot.get("hotwords", ())))

    def loop(self, seed: int, spans: Spans):
        """The seed's traffic in its loop, after a warm-up of its shapes; and the inputs."""
        mix, search = self.mix, self.search
        made = traffic.make(mix, seed, self.ctx)
        self.kind = made["kind"]
        if self.kind == "batch":
            pool = made["pool"]
            call_kw = dict(search, **mix.get("decode", {}))  # the hotwords among them
            # every batch has the same sizes, so one call takes every capture
            BatchLoop(self.decoder, pool, call_kw, Spans(), Sample(1, traffic.seeded(0))).call()
            return BatchLoop(self.decoder, pool, call_kw, spans, Sample(mix["check"], traffic.seeded(seed, 3))), pool
        self.chunk_frames = made["chunk_frames"]
        start_kw = dict(beam_width=search["beam_width"])
        if self.hot:
            start_kw["hotwords_enabled"] = True
        call_kw = dict({k: v for k, v in search.items() if k != "beam_width"}, **self.hot)
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
        """The reference decoder at ``precision`` over its own read of the ARPA files, with the mix's hotwords."""
        from ..reference.arpa import ArpaModel
        from ..reference.decoder import HOTWORD_WEIGHT, Member, ReferenceDecoder

        if self._models is None:
            t0 = time.perf_counter()
            self._models = [ArpaModel.cached(str(files["arpa"])) for files in self.member_files]
            log(f"reference: ARPA read in {time.perf_counter() - t0:.1f} s")
        hot = dict(hotwords=self.hot.get("hotwords", ()), hotword_weight=self.hot.get("hotword_weight", HOTWORD_WEIGHT))
        if "members" in self.cfg:
            members = [Member(model, w["alpha"], w["beta"], w["unk_score_offset"], w["lm_score_boundary"])
                       for model, (_, w) in zip(self._models, self.members)]
            return ReferenceDecoder(self.labels, members, precision=precision, **hot)
        dec = self.cfg["decoder"]
        return ReferenceDecoder(self.labels, self._models[0], alpha=dec["alpha"], beta=dec["beta"],
                                unk_score_offset=dec["unk_score_offset"], score_boundary=dec["lm_score_boundary"],
                                precision=precision, **hot)

    def words(self) -> List:
        """The word lists by which an LM state's ids are read back: the LM's, or one a member for an ensemble."""
        words = [model.words for model in self._models]
        return words if "members" in self.cfg else words[0]

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
        words = self.words()
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


def measure_window(cell: Cell, loop, rec: Dict, seconds: float) -> None:
    """The measured window: the loop driven for ``seconds``, its work and latencies into ``rec``."""
    if cell.kind == "batch":
        window = loop.run(seconds)
        frames = sum(c["frames"] for c in window["calls"])  # the audio of the utterances answered
        rec["window"] = dict(start=window["start"], end=window["end"], audio_s=frames * cell.cfg["frame_s"],
                             calls=len(window["calls"]))
        took = [c["t1"] - c["t0"] for c in window["calls"]]
        half = len(took) // 2
        log(f"window: {len(took)} calls, {rec['window']['audio_s']:.1f} audio-s in "
            f"{window['end'] - window['start']:.3f} s; a call's median s, first half "
            f"{statistics.median(took[:half] or took):.4f}, second half {statistics.median(took[half:]):.4f}")
        return
    loop.open()
    w0 = time.perf_counter()
    loop.schedule(w0)
    served = loop.serve_until(w0 + seconds)
    rec["window"] = dict(start=w0, end=w0 + seconds, chunks=len(served))
    # a failed chunk is missing: counted in ``failed`` (and the run not correct), not as a latency
    rec["latency_ms"] = [(c["end"] - c["due"]) * 1e3 for c in served if not c["failed"]]
    rec["service_ms"] = [(c["end"] - c["start"]) * 1e3 for c in served if not c["failed"]]
    log(f"window: {len(served)} chunks served, {loop.finished} utterances finished")


def traced_stretch(cell: Cell, loop) -> List[Dict]:
    """The calls traced after the window: a batch mix's ``trace_calls`` calls, or ``trace_s`` s of the streams.

    The streams run at their own pace: the chunks that fell due while the
    profiler started are moved on first.
    """
    if cell.kind == "batch":
        return [loop.call() for _ in range(cell.mix["trace_calls"])]
    log(f"trace: due times moved {loop.shift_to(time.perf_counter()) * 1e3:.1f} ms later")
    return loop.serve_until(time.perf_counter() + cell.mix["trace_s"])


def _drain(tr, rec: Dict, phase: str) -> None:
    """The program's spans and counters of ``phase`` into ``rec["program"]`` (``harness.program``), where on."""
    if tr is not None:
        rec.setdefault("program", {})[phase] = program.drain(tr)


def run_cell(bench: Dict, cell_name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t_start: Optional[float] = None, cache_dir: Path = CACHE_DIR) -> Dict:
    """One run of ``cell_name``; returns the result line's object (``compared`` last).

    With ``trace`` the program's own tracer is on from before the decoder's
    build to the end of the traced stretch, and is drained at the end of
    each phase into ``rec["program"]``; without it the tracer stays off.
    """
    t_start = time.perf_counter() if t_start is None else t_start
    import torch

    spans = Spans()
    with _program_tracer(trace) as tr:
        cell = Cell(bench, cell_name, device, cache_dir)
        loop, inputs = cell.loop(seed, spans)
        if device == "cuda":
            torch.cuda.synchronize()
        spans.items.clear()
        rec: Dict = dict(kind=cell.kind, lm_build_s=cell.lm_build_s, trace=None,
                         setup_s=time.perf_counter() - t_start)
        log(f"set-up {rec['setup_s']:.2f} s: the decoder's build {cell.lm_build_s:.2f} s")
        _drain(tr, rec, "setup")
        measure_window(cell, loop, rec, seconds)
        _drain(tr, rec, "window")
        rec["spans"] = list(spans.items)
        if trace:  # the traced stretch, after the measured window
            first = len(spans.items)
            traced, rows, offset = _trace(torch, device, spans, lambda: traced_stretch(cell, loop))
            _drain(tr, rec, "traced")

    breakdown = None
    if trace:
        from .trace import summarize

        t_read = time.perf_counter()
        ranges = [(name, a + offset, b + offset) for name, a, b in spans.items[first:]]
        # an idle gap is named by the innermost span open at its middle, the program's included
        summary = summarize(rows, ranges + program.ranges(rec["program"]["traced"], offset, ranges))
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
        rec["shape"] = cell.shape()

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
