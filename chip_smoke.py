"""Chip smoke test: build the CUDA kernels, check them and time them alone, check the port's main paths.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py [--out DIR]

It times kernels, one at a time, and nothing larger: the speed of whole
decodes and streams is the benchmark's (``cardbench/``). Phases (any failed
check exits non-zero and prints no result line):

1. device: the card's name and power limit (``nvidia-smi``);
2. build: ``nvcc`` compiles every ``pyctcdecode_torch/csrc/*.cu`` for sm_90a,
   all sources at once;
3. merge kernels: each CUDA kernel against its plain PyTorch version on the
   card, on random inputs made with numpy from fixed seeds, at the main
   paths' shapes (B = 100 beams; the dense path's N = 32 utterances with
   K = 29 tokens for its step and K = 1 for its final text merge, with and
   without the window; the serving path's length groups of N = 16 with K = 5
   per-utterance chunk token planes with empty slots and the window off for
   its step, and K = 1 with the window off for its final merge; the chunk
   step at N = 32 as well; the bpe path's BPE form, lmax 5, at [32, 129, 100]
   and chunk [16, 5, 100]), at B = 1024, and at every cluster size (blocks
   per utterance) beside the one the kernel picks from K. Tolerances: scores
   and merged logits within atol 1e-5 + rtol 1e-6 (the kernel sums
   exponentials in another order); ``src`` exact at live entries; the pruned
   (DEAD) sets equal except within that tolerance of the window threshold;
4. native: the C++ n-gram engine built with ``g++``; ``build_ctcdecoder``
   over the parity-scale 3-gram (200k words, 1.5M bigrams, 1.1M trigrams,
   written from a seed under ``build/``; ``"auto"`` reads plain ARPA with the
   engine: the decoder of every later path) against the same decoder over
   the file read in Python: the device tables equal (unigrams, trie, sizes,
   seeds exactly; each bucket row's residents, whose slots may be ordered
   otherwise: counted), the first 4 utterances decode equal (lm_score
   difference 0);
5. gather kernels: ``gather_rows`` against ``table[idx]``, bit-exact, at the
   shape of the reference's gather probe (int32 [524288, 64] table, 38 400
   queries, seeded alike), at the bucket rows' width (128 words), at ragged
   query counts, and with its slot select on the parity LM's own trie plane
   with the nodes of a real step of the dense decode ([32, 100]) and of a
   serving decode's length group ([16, 100]); timed beside the plain version
   and ``torch.index_select`` (the library call, used nowhere in the
   package). ``probe_rows`` (the hashes, bucket-row reads and fingerprint
   readout of every n-gram order >= 2 in one launch) against its plain
   version, bit-exact, on the queries of the same two real steps and on
   seeded queries that hit every order, warm and with the L2 cache flushed;
   over 2 and 4 row windows of the same planes (the row-sharded path's),
   each window against its plain version and summed bit-equal to the whole
   probe; then the same 3-gram written as a KenLM PROBING binary (the
   port's writer) and read by ``build_ctcdecoder``: that decoder's dense
   step issues the same queries, and ``probe_rows`` in its KenLM hash mode
   on them (and on seeded queries) is held bit-exact and timed the same way;
6. dense path: ``decode_batch`` of 32 synthetic dev-other utterances at beam
   100 with every token expanded (K = 29). The launch counters must show one
   ``expand_merge_prune``, one ``replay_winners``, one ``gather_rows`` (trie
   rows), one ``commit_words`` launch (the word commit, its probes
   in-kernel) and one ``walk_partial`` launch (the trie walk and partial
   score) per launched step, and per finalization one ``merge_prune``,
   two ``probe_rows`` (the last word and ``</s>``) and one
   ``backtrace_paths`` launch; the same decode again gives the same texts;
7. serving path: the same utterances through ``decode_batch(...,
   token_chunking=True, blank_collapse=True, length_bucketing=16)`` (two
   length groups) and through ``decode_beams_batches`` over the first 8
   utterances and the same reversed. Texts equal the dense path's, lm_score
   within 1e-3 of it, the pipelined generator gives the serving call's
   results batch by batch, and the launch counters equal the steps that the
   host prep implies;
8. segments: every decode of the run goes through the port's segment
   programs (``segment_frames``, 16 by default on CUDA): each segment of 16
   steps is one replay of a captured CUDA graph, and the steps pad to whole
   segments (a replay adds to each wrapper's counter the launches its
   capture recorded). The dense and the serving call (then hot2lm's and
   bpe's dense call, in their phases) run with ``segment_frames`` 0 (the
   eager loop) and 16, each on a clone with no graph yet, then once more
   warm: the graphs' results equal the eager loop's (texts, frames, LM
   states, lm_score difference 0), every call's launch counts equal
   ``expected_counts``; the dense call also at 4 and 32 steps a segment. The
   end of one decode is run both ways on the state its segments left: the
   finalize eagerly and the plain backtrace, against the finalize graph's
   replay and ``backtrace_paths``: equal to the bit. The shortest utterance
   decodes whole again with a ``device="cpu"`` decoder (the plain versions),
   dense and serving: identical texts, frames and LM states, lm_score within
   1e-3;
9. sharded: ``ShardedCTCDecoder(shard_lm=True)`` over a world-size-1 NCCL
   group brought up by ``parallel.launch``, member A's bucket planes
   row-sharded, every probe one collective round trip; through the main
   decoder's captured graphs (the collectives captured inside them, a warm
   call capturing nothing) and in an eager column (a wrapped decoder made
   with ``with_options(segment_frames=0)``); the dense call and the serving
   options (chunks, blank collapse), both with ``collect_stats``, on both
   columns: results equal phases 6 and 7's (lm_score difference 0), counters
   equal the unsharded decoder's, launches as the code implies;
10. evaluation: ``evaluation.evaluate_corpus`` on the main decoder for the
   dense configuration: its hypotheses the dense phase's texts and its
   launches those of its two decodes; ``compare_engines`` of the host oracle
   over the same LM against the card on the first 4 utterances (top-1
   agreement, which must be 1; the card's hypotheses the dense phase's);
   ``utils.normalize_to_logp_torch`` on the card against the CPU (logits and
   probabilities, within 1e-6);
11. hot2lm: a ``MultiLanguageModel`` of two members (the parity 3-gram
   above, and the same seed's 3-gram at half the bigrams and trigrams with
   other fusion settings) and 28 hotwords (24 transcript words, 2 transcript
   phrases, 2 strings no LM knows) at the default hotword weight, through
   the dense call, the serving call and ``decode_beams_batches``. Per step
   the counters must show one ``gather_rows`` launch per member and one
   ``commit_words`` for both, per finalization one ``probe_rows`` for the
   last word per member plus one for ``</s>`` where the member scores it.
   Member B's ``gather_rows`` and ``probe_rows`` are held bit-exact on its
   own tables with a real step's nodes and queries, and timed; the first
   utterance, and the first utterance whose top text the hotwords change,
   decode identically on the CPU (50 frames; ``MultiLMState`` last states);
   graphs equal the eager loop;
12. bpe: a 128-piece vocabulary of Conformer-CTC's width (V = 129 with the
   blank, ``▁⁇▁`` bounded on the right, labels up to ``▁`` + 4 letters, grown
   from the parity LM's words) over the same 32 references, split into
   pieces, with the same noise model at 0.04 s a frame. ``expand_merge_prune``
   in its BPE form on a real dense and serving step against its plain
   version at every cluster size; the dense call (K = 129), the serving call
   and ``decode_beams_batches`` with member A, and one dense call with
   hot2lm's two members and hotwords, each with its launch counts; serving
   and pipelined texts equal the dense texts; the first utterance identical
   on the CPU (50 frames; member A, and the two members with the hotwords);
   graphs equal the eager loop, and the captured end of a decode the eager
   one;
13. backtrace: ``backtrace_paths`` (``csrc/backtrace.cu``) against its plain
   version, bit-exact, on the logs and ranked beams that real decodes left
   (phase 8's ends): dense [32, 544, 100] int8 with all 100 ranks and with
   the decode's top 1, a serving group's timeline logs (with -3 carry
   markers), and bpe dense (int16 paths); each timed beside the plain
   version, with its bound (the log entries the chains read, ``src`` and the
   paths);
14. winner replay: ``replay_winners`` (``csrc/replay.cu``) against its plain
   version, bit-exact, on the arguments one real step gave it (recorded on
   the eager loop at frame 60): the dense char step [32, 100] and the same
   at N = 1, both with ``prune_history`` off as the benchmark's cells run,
   and the bpe dense step [32, 100] (K = 129, lmax 5, int16 tokens); each
   timed beside the plain version, with its bound;
15. word commit: ``commit_words`` (``csrc/gather.cu``) against its plain
   version (the step's PyTorch composition around ``probe_rows``),
   bit-exact, on the arguments one real step gave it (frame 60): the dense
   char step [32, 100], the same with ``collect_stats`` and at N = 1, the
   hot2lm step (two members, the hotwords) and the bpe dense step; each
   timed beside the plain version, with its bound;
16. trie walk: ``walk_partial`` (``csrc/walk.cu``) against its plain version
   (the step's PyTorch composition), bit-exact, on the arguments one real
   step gave it (frame 60): the dense char step [32, 100] (K 29, one level),
   the dense step over wav2vec2-base-960h's 32 labels with the same LM (K 32,
   ``</s>``: four levels), the bpe dense step (K 129, five levels), the
   hot2lm step (two members, the hotwords) and an N = 1 stream step; each
   timed back to back, warm and with the L2 cache flushed before each call,
   beside the plain version and its bound;
17. stream: ``get_starting_state`` / ``partial_decode_beams`` in chunks of 25
   frames, beam 100, each decoder's tables put back on the card for it,
   every path in two columns: through captured graphs (the default) and on a
   ``with_options(segment_frames=0)`` clone (the eager loop). The graph
   stream's views and carried state equal the eager stream's to the bit at
   every chunk, for char, hot2lm and bpe. The first 2 utterances, each on
   its own state with member A: the last view (``is_end``) equals the full
   decode, the launch counters equal one step per launched step (padded to
   whole segments under graphs), one finalize per chunk and no batch
   backtrace; the same two streams interleaved chunk by chunk on one decoder
   give each stream's views alone. Each kernel against its plain version on
   the inputs a stream gives it (frame 60's step [1, 29, 100], its trie
   nodes and n-gram queries, and its chunk's finalize [1, 1, 100]), timed.
   Utterance 0 with ``force_next_word`` at its middle chunk: every chunk's
   top view equals the host oracle's (``BeamSearchDecoderCTC``, within
   2e-3), graphs equal eager; its first 2 chunks give identical views on the
   CPU. hot2lm's stream equals the full decode, and with the hotword list
   written anew from the middle chunk on, the host oracle's top views; the
   bpe stream equals the full decode;
18. kenlm: the decoder over member A's PROBING binary (phase 5) saved with
   ``save_to_dir`` and loaded back with
   ``TorchBeamSearchDecoderCTC.load_from_dir``; its ``probe_rows`` on a real
   dense step bit-exact; the 32 utterances dense and serving: texts, frames
   and LM states equal the ARPA decoder's, ``lm_score`` within 1e-4, the
   launch counts the code implies. Member B as a QUANT_TRIE binary (8 + 8
   bits) through a saved directory: 2 utterances on the card equal the host
   oracle's loaded from the same directory (top texts; scores within 2e-3).

Kernel times are device times: the summed CUPTI durations of a call's
kernels under ``torch.profiler`` over 30 calls (:func:`time_call`), warm and,
where a real caller finds the cache cold, with the L2 cache flushed before
each call; each beside its bound, the larger of the bytes it must move over
the card's memory rate and its operations over the float32 rate. The CPU
cross-checks of phases 11 and 12 decode the first ``CPU_FRAMES`` frames of
their utterances (the card's batch texts are checked on the whole
utterance); ``decode_beams_batches`` runs the first ``PIPE_UTTS``
utterances; the stream phase streams ``STREAM_UTTS`` utterances and holds
``STREAM_CPU_CHUNKS`` chunks against the CPU.

The last three lines are the kernel record (JSON), the ``nvidia-smi`` name and
power limit, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

LIBRI_LABELS = [" "] + list("abcdefghijklmnopqrstuvwxyz") + ["'", ""]
N_UTTS = 32
GROUP_ROWS = 16  # rows of one length group of the serving call
BEAM = 100
K_TOKENS = len(LIBRI_LABELS)
ATOL, RTOL = 1e-5, 1e-6
CPU_CHECK = 1  # utterances decoded again on the CPU (its plain versions are the host's costliest step)
CPU_FRAMES = 50  # frames of each utterance the CPU cross-checks decode (the card decodes the same cut)
HOT_CPU_CHANGED = 1  # hot2lm: utterances whose top text the hotwords change, also held against the CPU
LM_SCORE_TOL = 1e-3
RERUN_TOL = 1e-4  # the same decode again on the same card
SERVING = dict(token_chunking=True, blank_collapse=True, length_bucketing=GROUP_ROWS)
CHUNK = 5  # token_chunking=True
WIDE_BEAM, WIDE_ROWS = 1024, 8  # the widest beam the merge kernels take, on a smaller batch
CLUSTERS = (1, 2, 4, 8)  # blocks per utterance the merge kernels can be forced to
PROBE_ROWS, PROBE_WIDTH, PROBE_QUERIES = 524_288, 64, 38_400  # the reference's gather probe
# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s and float32
# (non-tensor-core) operations/s; the kernels' scalar int32/f32 work is
# counted against the latter
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
REPS = 30
WINDOW_REPS = 10  # calls a row window's timing sums over (six windows, each warm and L2-flushed)
PROFILE_TRIES = 4
PIPE_UTTS = 8  # utterances of each of the two batches through decode_beams_batches
SEG = 16  # the decoders' segment_frames on the card (their default): each segment a captured CUDA graph
SEG_SIZES = (4, 32)  # other segment sizes the segments phase runs the dense path at
L2_FLUSH_BYTES = 256 << 20  # five times the H100's 50 MB L2
FLUSH_KERNEL = "FillFunctor"  # the kernel of Tensor.fill_, which none of the timed calls runs
# the hot2lm path: member B's fusion settings (the JAX package's mixed-member
# test settings) and the hotword list's make-up
MEMBER_B = dict(alpha=0.3, beta=2.0, unk_score_offset=-6.0, score_boundary=False)
HOT_SEED, HOT_UNIGRAMS, HOT_PHRASES, HOT_UNKNOWN = 13, 24, 2, 2
# the bpe path: a piece vocabulary of the width of NeMo's English Conformer-CTC
# checkpoints (a 128-piece SentencePiece tokenizer, the blank appended as the
# last logit column), grown from the parity LM's words; Conformer's 4x
# subsampling of 10 ms frames
BPE_QUOTA = {2: 13, 3: 12, 4: 12}  # multi-letter pieces by length, word-initial and inner each
BPE_V, BPE_LMAX = 129, 5  # logit columns; the longest label, ▁ + 4 letters
BPE_FRAME_SEC = 0.04
BPE_SEED = 3
# the w2v2 walk case: wav2vec2-base-960h's tokenizer's 32 outputs in order (<pad> the blank, | the
# word delimiter), the char corpus's logits moved to their columns, the markers at each frame's floor
W2V2_LABELS = ["<pad>", "<s>", "</s>", "<unk>", "|", "e", "t", "a", "o", "n", "i", "h", "s", "r", "d", "l",
               "u", "m", "w", "c", "f", "g", "y", "p", "b", "v", "k", "'", "x", "j", "q", "z"]
# the stream path: chunks of 0.5 s of audio at 0.02 s a frame
STREAM_UTTS, STREAM_CHUNK = 2, 25
STREAM_CPU_CHUNKS = 2  # chunks of one stream held against the CPU (the plain versions take ~0.1 s a frame there)
HOST_TOL = 2e-3  # the float64 host oracle against the float32 device
# the kenlm path: member A as a KenLM PROBING binary, member B as QUANT_TRIE
KENLM_TOL = 1e-4  # the binary holds the ARPA's f32 probabilities: the same sums, in the same order
QUANT_BITS = (8, 8)  # kenlm build_binary's default -q 8 -b 8
QUANT_UTTS = 2
NATIVE_UTTS = 4  # utterances decoded over both readers' tables in the native phase
EVAL_HOST_UTTS = 4  # utterances compare_engines decodes on the host oracle and the card
NORM_TOL = 1e-6  # normalize_to_logp_torch on the card against the CPU (atol and rtol)


_T0 = time.perf_counter()


def log(msg: str) -> None:
    """Print a progress line, stamped with the seconds since the script started."""
    print(f"{time.perf_counter() - _T0:7.1f}s {msg}", flush=True)


class CheckFailed(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def _is_device_row(ev) -> bool:
    return str(getattr(ev, "device_type", "")).endswith("CUDA")


def _device_us(ev) -> float:
    us = getattr(ev, "self_device_time_total", None)
    if us is None:
        us = getattr(ev, "self_cuda_time_total", 0.0)
    return float(us or 0.0)


def time_call(torch, fn, reps: int = REPS, flush=None):
    """(device ms, call ms) per call of ``fn``.

    Device ms: the summed CUPTI durations of the kernels (and memsets) the
    call runs, per call, over ``reps`` calls under ``torch.profiler`` — the
    card's own time, free of Python overhead. Call ms: median CUDA-event
    time around single calls, which includes the launch gaps a caller pays.
    ``flush`` (a fill of a buffer larger than the L2 cache) runs before every
    profiled call, so that ``fn`` finds the cache cold; the fill kernels'
    own rows are left out of the sum. The trace drops the first kernels it
    sees, so the ``reps`` calls run twice, as the profiler's warm-up cycle
    (discarded) and as its measured cycle; a measured cycle in which some
    kernel did not run a multiple of ``reps`` times is incomplete and taken
    again. Where the profiler keeps returning empty or incomplete traces,
    device ms is instead the CUDA-event time of ``reps`` calls issued back
    to back, per call (launch gaps included; not available with ``flush``,
    where it is NaN), and the log says so.
    """
    from torch.profiler import ProfilerActivity, profile, schedule

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    dev_us = 0.0
    for attempt in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            for _ in range(2):  # the warm-up cycle, then the measured one
                for _ in range(reps):
                    if flush is not None:
                        flush()
                    fn()
                torch.cuda.synchronize()
                prof.step()
        rows = [ev for ev in prof.key_averages()
                if _is_device_row(ev) and not (flush is not None and FLUSH_KERNEL in ev.key)]
        dev_us = sum(_device_us(ev) for ev in rows)
        counts = sorted({int(ev.count) for ev in rows})
        if dev_us > 0 and all(c % reps == 0 for c in counts):
            break
        log(f"[profiler] {'empty' if dev_us <= 0 else f'incomplete (kernel counts {counts} for {reps} calls)'} "
            f"trace (attempt {attempt + 1} of {PROFILE_TRIES})")
        dev_us = 0.0
        time.sleep(0.5)
    if dev_us <= 0 and flush is None:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        dev_us = start.elapsed_time(end) * 1e3
        log("[profiler] no trace: device ms below is the event time of back-to-back calls, launch gaps included")
    elif dev_us <= 0:
        dev_us = float("nan")
        log("[profiler] no trace: the L2-flushed time below is not measured")
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return dev_us / reps / 1e3, statistics.median(times)


def nbytes(tensors) -> int:
    return int(sum(t.numel() * t.element_size() for t in tensors))


def bound_ms(bytes_moved: int, ops: float):
    t_bytes = bytes_moved / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_F32 * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(name: str, got, want, prune) -> float:
    """Hold kernel outputs against the plain version's; return max abs error."""
    import torch

    score, merged, src = (x.detach().cpu() for x in got)
    w_score, w_merged, w_src = (x.detach().cpu() for x in want)
    finite = torch.isfinite(w_merged)
    check(torch.equal(torch.isfinite(merged), finite), f"{name}: merged finite sets differ")
    err_m = (merged[finite] - w_merged[finite]).abs()
    check(bool((err_m <= ATOL + RTOL * w_merged[finite].abs()).all()),
          f"{name}: merged off by {float(err_m.max())}")
    live_k, live_w = score > -1e29, w_score > -1e29
    both = live_k & live_w
    err_s = (score[both] - w_score[both]).abs()
    check(bool((err_s <= ATOL + RTOL * w_score[both].abs()).all()),
          f"{name}: score off by {float(err_s.max()) if err_s.numel() else 0.0}")
    check(torch.equal(src[live_w & live_k], w_src[live_w & live_k]), f"{name}: src differs at live entries")
    differ = live_k ^ live_w
    if bool(differ.any()):
        # pruned-set differences only at the window threshold
        n = score.shape[0]
        thr = w_score.reshape(n, -1).amax(dim=1) + prune.cpu()
        thr = thr[:, None, None].expand_as(score)
        val = torch.where(live_k, score, w_score)
        gap = (val - thr).abs()[differ]
        check(bool((gap <= ATOL + RTOL * thr[differ].abs()).all()),
              f"{name}: DEAD sets differ away from the window threshold")
    check(bool(both.any()), f"{name}: no live entries to compare")
    err = float(err_m.max()) if err_m.numel() else 0.0
    if err_s.numel():
        err = max(err, float(err_s.max()))
    return err


def merge_inputs(torch, dev, rng, n, k, b, window=True):
    kl = rng.randint(0, 6, size=(n, k, b)).astype(np.int64)
    kh = (kl * 2654435761) & 0xFFFFFFFF
    valid = (rng.rand(n, k, b) < 0.7).astype(np.int32)
    logit = np.where(valid, rng.randn(n, k, b) - 5.0, -1e30).astype(np.float32)
    extra = (rng.randn(n, k, b) * 2).astype(np.float32)
    prune = np.full(n, -10.0 if window else -np.inf, dtype=np.float32)
    return [torch.as_tensor(a).to(dev) for a in (kl, kh, valid, logit, extra, prune)]


def expand_inputs(torch, dev, rng, n, k, b, lmax, chunk=False, vocab=K_TOKENS):
    def lanes(shape):
        return torch.as_tensor(rng.randint(0, 4, size=shape).astype(np.int64)).to(dev)

    beam = {
        "text_lo": lanes((n, b)), "text_hi": lanes((n, b)),
        "cm_text_lo": lanes((n, b)), "cm_text_hi": lanes((n, b)),
        "p_lo": lanes((n, b)), "p_hi": lanes((n, b)),
        "force": torch.as_tensor(rng.randint(0, 2, (n, b)).astype(np.int32)).to(dev),
        "fused": torch.as_tensor(rng.randn(n, b).astype(np.float32)).to(dev),
        "wfused": torch.as_tensor(rng.randn(n, b).astype(np.float32)).to(dev),
        "logit": torch.as_tensor(
            np.where(rng.rand(n, b) < 0.8, rng.randn(n, b) - 20.0, -1e30).astype(np.float32)
        ).to(dev),
        "last_tok": torch.as_tensor(rng.randint(-3, k, (n, b)).astype(np.int32)).to(dev),
    }
    tok = {
        "tok": torch.as_tensor(np.tile(np.arange(k, dtype=np.int32), (n, 1))).to(dev),
        "blank": torch.as_tensor((rng.rand(n, k) < 0.1).astype(np.int32)).to(dev),
        "boundary": torch.as_tensor((rng.rand(n, k) < 0.2).astype(np.int32)).to(dev),
        "right": torch.as_tensor((rng.rand(n, k) < 0.2).astype(np.int32)).to(dev),
        "seed_lo": lanes((n, k)), "seed_hi": lanes((n, k)),
        "tok_logp": torch.as_tensor((-rng.rand(n, k) * 8).astype(np.float32)).to(dev),
        "admit": torch.as_tensor((rng.rand(n, k) < 0.6).astype(np.int32)).to(dev),
    }
    if chunk:
        # one timeline chunk per utterance: distinct ascending ids that differ
        # from row to row, ending in empty slots (id -1: clamped to 0 for
        # lookups, not admitted), as the serving step feeds the kernel
        ids = np.stack([np.sort(rng.choice(vocab, size=k, replace=False)) for _ in range(n)])
        holes = np.arange(k)[None, :] >= rng.randint(1, k + 1, size=(n, 1))
        tok["tok"] = torch.as_tensor(np.where(holes, 0, ids).astype(np.int32)).to(dev)
        tok["admit"] = torch.as_tensor((~holes).astype(np.int32)).to(dev)
        beam["logit"][-1] = -1e30  # an utterance with no live beam
    cids = torch.as_tensor(rng.randint(-1, 31, (lmax, n, k)).astype(np.int32)).to(dev)
    pscore = torch.as_tensor((rng.randn(n, k, b) * 0.5).astype(np.float32)).to(dev)
    prune = torch.full((n,), float("-inf") if chunk else -10.0, dtype=torch.float32, device=dev)
    return beam, tok, cids, pscore, prune


def by_cluster(torch, label: str, fn, want, prune, picked_ms: float) -> dict:
    """The kernel forced to each cluster size: held against ``want``, timed (device ms)."""
    out = {}
    for cluster in CLUSTERS:
        got = fn(cluster)
        torch.cuda.synchronize()
        compare(f"{label} cluster={cluster}", got, want, prune)
        out[cluster] = time_call(torch, lambda: fn(cluster))[0]
    log(f"{label}: blocks per utterance forced to " +
        ", ".join(f"{c}: {ms:.4f} ms" for c, ms in out.items()) + f"; picked from K: {picked_ms:.4f} ms")
    return out


def merge_case(torch, merge, label: str, args):
    """``merge_prune`` on ``args`` against its plain version: (record, the plain version's outputs)."""
    got = merge.merge_prune(*args)
    torch.cuda.synchronize()
    check(not bool(torch.isnan(got[0]).any()), f"{label}: NaN in the scores")
    want = merge.merge_prune_ref(*args)
    err = compare(label, got, want, args[5])
    ms, call = time_call(torch, lambda: merge.merge_prune(*args))
    plain, plain_call = time_call(torch, lambda: merge.merge_prune_ref(*args))
    n, k, b = args[0].shape
    n_valid = int(args[2].sum())
    b_ms, b_by = bound_ms(nbytes(args) + nbytes(got), 3.0 * b * n_valid)
    log(f"{label}: max_abs_err {err:.3g}, kernel {ms:.4f} ms "
        f"(call {call:.4f}), plain {plain:.4f} ms (call {plain_call:.4f}), "
        f"bound {b_ms:.5f} ms ({b_by})")
    return dict(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=None, max_abs_err=err,
                shape=[n, k, b], call_ms=call, plain_call_ms=plain_call), want


def expand_case(torch, merge, label: str, eargs):
    """``expand_merge_prune`` on ``eargs`` against its plain version: (record, the plain version's outputs)."""
    beam, tok, cids, pscore, prune, _ = eargs
    got = merge.expand_merge_prune(*eargs)
    torch.cuda.synchronize()
    want = merge.expand_merge_prune_ref(*eargs)
    err = compare(label, got, want, prune)
    ms, call = time_call(torch, lambda: merge.expand_merge_prune(*eargs))
    plain, plain_call = time_call(torch, lambda: merge.expand_merge_prune_ref(*eargs))
    ins = list(beam.values()) + list(tok.values()) + [cids, pscore, prune]
    n, k, b = pscore.shape
    lmax = cids.shape[0]
    alive = beam["logit"] > -1e29
    n_valid = int((alive[:, None, :] & (tok["admit"][:, :, None] != 0)).sum())
    # pairwise key tests + ~26 scalar ops per candidate to build it, and 4
    # per character of its partial-word hash
    ops = 3.0 * b * n_valid + (26.0 + 4.0 * lmax) * n * k * b
    b_ms, b_by = bound_ms(nbytes(ins) + nbytes(got), ops)
    log(f"{label}: max_abs_err {err:.3g}, kernel {ms:.4f} ms (call {call:.4f}), "
        f"plain {plain:.4f} ms (call {plain_call:.4f}), bound {b_ms:.5f} ms ({b_by}), {n_valid} valid candidates")
    return dict(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=None, max_abs_err=err,
                shape=[n, k, b], call_ms=call, plain_call_ms=plain_call), want


def kernel_phases(torch, merge) -> dict:
    """Each merge kernel vs its plain version on the card; times; bounds."""
    dev = torch.device("cuda")
    rec = {}
    # (N, K, B, window): the batched form, the finalize's shape, and the finalize
    # as it runs (no window: prune = -inf) on the dense batch and on one
    # length group of the serving call; then the widest beam
    for n, k, b, window in ((N_UTTS, K_TOKENS, BEAM, True), (N_UTTS, 1, BEAM, True), (N_UTTS, 1, BEAM, False),
                            (GROUP_ROWS, 1, BEAM, False), (WIDE_ROWS, 1, WIDE_BEAM, False),
                            (WIDE_ROWS, K_TOKENS, WIDE_BEAM, True)):
        args = merge_inputs(torch, dev, np.random.RandomState(100 + k + (n != N_UTTS) * 1000), n, k, b, window)
        label = f"merge_prune[{n},{k},{b}]" + ("" if window else " window off")
        key = f"n={n},k={k}" + ("" if b == BEAM else f",b={b}") + ("" if window else ",window off")
        rec[("merge_prune", key)], want = merge_case(torch, merge, label, args)
        if k > 1:
            rec[("merge_prune", key)]["ms_by_cluster"] = by_cluster(
                torch, label, lambda c: merge.merge_prune(*args, cluster=c), want, args[5],
                rec[("merge_prune", key)]["ms"])
        del args, want
    # (N, K, B, lmax, BPE, chunk): the dense step, the serving chunk step at the
    # dense batch's rows and at a length group's, the bpe path's dense step
    # (K = V = 129) and chunk step, the widest beam
    for n, k, b, lmax, is_bpe, chunk in (
            (N_UTTS, K_TOKENS, BEAM, 1, False, False), (N_UTTS, CHUNK, BEAM, 1, False, True),
            (GROUP_ROWS, CHUNK, BEAM, 1, False, True), (N_UTTS, BPE_V, BEAM, BPE_LMAX, True, False),
            (GROUP_ROWS, CHUNK, BEAM, BPE_LMAX, True, True),
            (WIDE_ROWS, K_TOKENS, WIDE_BEAM, 1, False, False), (WIDE_ROWS, CHUNK, WIDE_BEAM, 1, False, True)):
        beam, tok, cids, pscore, prune = expand_inputs(
            torch, dev, np.random.RandomState((300 if chunk else 200 + lmax) + (n != N_UTTS) * 1000), n, k, b, lmax,
            chunk, BPE_V if is_bpe else K_TOKENS,
        )
        eargs = (beam, tok, cids, pscore, prune, is_bpe)
        label = f"expand_merge_prune[{n},{k},{b}] lmax={lmax} bpe={is_bpe}"
        if chunk:
            label += " chunk planes, window off"
            got = merge.expand_merge_prune(*eargs)
            check(not bool(torch.isnan(got[0]).any()), f"{label}: NaN in the scores")
            check(bool((got[0][-1] == -1e30).all()), f"{label}: a dead utterance has live candidates")
            dead_in = ~((beam["logit"] > -1e29)[:, None, :] & (tok["admit"] != 0)[:, :, None])
            check(bool((got[0][dead_in] == -1e30).all()), f"{label}: a DEAD member got through")
            del got
        key = f"n={n},k={k},lmax={lmax}" + ("" if b == BEAM else f",b={b}") + (",chunk,window off" if chunk else "")
        rec[("expand_merge_prune", key)], want = expand_case(torch, merge, label, eargs)
        rec[("expand_merge_prune", key)]["ms_by_cluster"] = by_cluster(
            torch, label, lambda c: merge.expand_merge_prune(*eargs, cluster=c), want, prune,
            rec[("expand_merge_prune", key)]["ms"])
        del eargs, want, beam, tok, cids, pscore
    torch.cuda.empty_cache()
    return rec


def record_step_reads(torch, decoder, logits, step: int, member: int = 0, **decode_kw):
    """The arguments ``gather_rows`` and ``probe_rows`` get in one real decode step.

    Decodes ``logits`` (``decode_batch`` with ``decode_kw``) with recorders
    in place of the two wrappers inside ``device_tables``: every step fetches
    each LM member's beams' trie rows (one ``gather_rows`` call with a slot
    a member) and, with the step's commit on its PyTorch composition
    (``commit_words_ref``, whose queries ``commit_words`` probes in-kernel),
    probes every n-gram order >= 2 (one ``probe_rows`` call a member). Only
    the calls on LM member ``member``'s own tables are kept.
    ``step`` counts from the start of the call's first decode (the first
    length group's, where the call splits). Returns ``{"gather": args,
    "probe": args}``.
    """
    from pyctcdecode_torch import engine
    from pyctcdecode_torch.models import device_tables
    from pyctcdecode_torch.ops.commit import commit_words
    from pyctcdecode_torch.ops.gather import gather_rows, probe_rows

    calls = {"gather": [], "probe": []}
    tabs = decoder._tabs["lms"][member]

    def keep(args):
        return tuple(a.clone() if isinstance(a, torch.Tensor) and a.dim() and a.dtype == torch.int64 else a
                     for a in args)

    def gather_recorder(*args):
        if args[0] is tabs["trie_rows"]:
            calls["gather"].append(keep(args))
        return gather_rows(*args)

    def probe_recorder(*args):
        if args[2] is tabs["fp"]:
            calls["probe"].append(keep(args))
        return probe_rows(*args)

    device_tables.gather_rows, device_tables.probe_rows = gather_recorder, probe_recorder
    engine.commit_words = engine.commit_words_ref  # the step's probes as one probe_rows call a member
    try:  # on the eager loop: a captured segment's replay calls no wrapper
        decoder.with_options(segment_frames=0).decode_batch(logits, beam_width=BEAM, **decode_kw)
    finally:
        device_tables.gather_rows, device_tables.probe_rows = gather_rows, probe_rows
        engine.commit_words = commit_words
    torch.cuda.synchronize()
    check(min(len(calls["gather"]), len(calls["probe"])) > step, "fewer row reads than steps were recorded")
    return {"gather": calls["gather"][step], "probe": calls["probe"][step]}


def make_flush(torch, dev):
    scratch = torch.empty(L2_FLUSH_BYTES, dtype=torch.int8, device=dev)
    return lambda: scratch.fill_(1)


def gather_phases(torch, gather, step_calls: dict, synthetic: bool = True) -> dict:
    """``gather_rows`` vs its plain version (bit-exact) and ``torch.index_select``; times; bounds.

    On the reference probe's synthetic shapes (``synthetic``) and on the
    trie fetch of each recorded real step in ``step_calls``.
    """
    dev = torch.device("cuda")
    rec = {}
    flush = make_flush(torch, dev)

    def one(label, table, idx, slot=None, stride=None, width=None, timed=True, cold=False):
        sel = (slot, stride, width)
        got = gather.gather_rows(table, idx, *sel)
        torch.cuda.synchronize()
        out_width = table.shape[1] if width is None else width
        check(got.dtype == torch.int32 and tuple(got.shape) == (*idx.shape, out_width),
              f"gather_rows {label}: bad output shape or dtype")
        want = gather.gather_rows_ref(table, idx, *sel)
        err = float((got.long() - want.long()).abs().max())
        check(torch.equal(got, want), f"gather_rows {label}: differs from the plain version by up to {err}")
        if not timed:
            log(f"gather_rows {label}: equal to the plain version")
            return
        # the library call: one index_select of whole rows, or of whole slots
        # of the table seen as [rows * slots per row, stride]
        if slot is None:
            lib_table, flat = table, idx.reshape(-1)
        else:
            lib_table = table.view(-1, stride)
            flat = (idx * (table.shape[1] // stride) + slot).reshape(-1)
        check(torch.equal(got.reshape(-1, out_width), torch.index_select(lib_table, 0, flat)[:, :out_width]),
              f"gather_rows {label}: differs from index_select")
        ms, call = time_call(torch, lambda: gather.gather_rows(table, idx, *sel))
        plain, plain_call = time_call(torch, lambda: gather.gather_rows_ref(table, idx, *sel))
        lib, lib_call = time_call(torch, lambda: torch.index_select(lib_table, 0, flat))
        # each distinct row (or slot) read once, each output row and each index once
        out_bytes = out_width * table.element_size()
        index_bytes = flat.numel() * idx.element_size() * (1 if slot is None else 2)
        distinct = int(flat.unique().numel())
        moved = (distinct + flat.numel()) * out_bytes + index_bytes
        b_ms, b_by = bound_ms(moved, 0.0)
        log(f"gather_rows {label}: table {list(table.shape)}, idx {list(idx.shape)} "
            f"({distinct} distinct), {out_bytes} bytes out per query: exact; kernel {ms:.4f} ms "
            f"(call {call:.4f}), plain {plain:.4f} ms (call {plain_call:.4f}), index_select {lib:.4f} ms "
            f"(call {lib_call:.4f}), bound {b_ms:.5f} ms ({b_by})")
        rec[label] = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms, bound_by=b_by,
                          max_abs_err=err, shape=[list(table.shape), list(idx.shape), out_width],
                          call_ms=call, plain_call_ms=plain_call, library_call_ms=lib_call)
        if cold:
            # the same calls with the L2 cache flushed before each: the bound is
            # a device-memory bound, and repeated calls on one index set would
            # otherwise find their rows in the cache
            c_ms, _ = time_call(torch, lambda: gather.gather_rows(table, idx, *sel), flush=flush)
            c_plain, _ = time_call(torch, lambda: gather.gather_rows_ref(table, idx, *sel), flush=flush)
            c_lib, _ = time_call(torch, lambda: torch.index_select(lib_table, 0, flat), flush=flush)
            log(f"gather_rows {label}, L2 flushed before each call: kernel {c_ms:.4f} ms, "
                f"plain {c_plain:.4f} ms, index_select {c_lib:.4f} ms")
            rec[label].update(cold_ms=c_ms, cold_plain_ms=c_plain, cold_library_ms=c_lib)

    if synthetic:
        rng = np.random.RandomState(0)  # the probe's seed, table and queries
        tab = torch.as_tensor(rng.randint(0, 1 << 30, size=(PROBE_ROWS, PROBE_WIDTH), dtype=np.int32)).to(dev)
        idx = torch.as_tensor(rng.randint(0, PROBE_ROWS, size=PROBE_QUERIES).astype(np.int64)).to(dev)
        one("probe", tab, idx, cold=True)
        wide = tab.reshape(PROBE_ROWS // 2, 2 * PROBE_WIDTH)
        one("probe, 128-word rows", wide, idx % wide.shape[0], cold=True)
        one("one query", tab, idx[:1], timed=False)
        one("ragged count", tab, idx[:1001], timed=False)
        one("2-D idx", tab, idx[: 7 * 33].reshape(7, 33).contiguous(), timed=False)
        # slots of the probe's table: whole 16-byte vectors (4 slots of 16 words), and a ragged cut
        one("slot select, 16 of 64 words", tab, idx[:1001], idx[:1001] % 4, 16, 16, timed=False)
        one("slot select, 13 of 64 words", tab, idx[:1001], idx[:1001] % 4, 16, 13, timed=False)
        one("width cut, 5 of 64 words", tab, idx[:1001], None, 64, 5, timed=False)
        del tab, wide
    for path, (rows, calls) in step_calls.items():
        table, step_idx, slot, stride, width = calls["gather"]
        label = f"{path} step: trie rows"
        check(tuple(step_idx.shape) == (rows, BEAM), f"gather_rows {label}: idx is not [{rows}, {BEAM}]")
        check(slot is not None and width < table.shape[1], f"gather_rows {label}: the trie fetch selects no slot")
        one(label, table, step_idx, slot, stride, width, cold=True)
    return rec


def seeded_probe_queries(torch, dev, ngrams, rows: int):
    """``(full, ctx_len)`` for ``[rows, BEAM]`` queries with hits at every order.

    Of every ``orders + 2`` queries, one ends in a present n-gram of each
    order >= 2 (under a -1 pad where the key is shorter than the id plane),
    one is random with a random context length, one random with a full one.
    """
    rng = np.random.RandomState(5)
    order = len(ngrams)
    q = rows * BEAM
    full = rng.randint(0, len(ngrams[0]), size=(q, order)).astype(np.int64)
    ctx_len = np.full(q, order - 1, dtype=np.int64)
    period = order + 1
    for n in range(2, order + 1):
        present = np.array(list(itertools.islice(ngrams[n - 1], 5000)), dtype=np.int64)
        at = np.arange(n - 2, q, period)
        full[at, order - n:] = present[rng.randint(0, len(present), size=len(at))]
        full[at, : order - n] = -1
        ctx_len[at] = n - 1
    at = np.arange(order - 1, q, period)
    ctx_len[at] = rng.randint(0, order, size=len(at))
    return (torch.as_tensor(full.reshape(rows, BEAM, order)).to(dev),
            torch.as_tensor(ctx_len.reshape(rows, BEAM)).to(dev))


def probe_phases(torch, gather, step_calls: dict, ngrams=None) -> dict:
    """``probe_rows`` vs its plain version, bit-exact; times; bounds.

    On the queries of a real step of each path, and, given ``ngrams`` (the
    LM's host tables, one dict of id tuples per order), on seeded queries
    that hit every order's table of the first path's LM. No single PyTorch
    call computes the probe, so there is no library time.
    """
    cases = {path: (rows, calls["probe"]) for path, (rows, calls) in step_calls.items()}
    dev = next(iter(cases.values()))[1][0].device
    rec = {}
    flush = make_flush(torch, dev)
    if ngrams is not None:
        first = next(iter(step_calls))
        tables, slots, sub_width = step_calls[first][1]["probe"][2:]
        seeded = "seeded" if first == "dense" else f"{first} seeded"
        cases[seeded] = (N_UTTS, (*seeded_probe_queries(torch, dev, ngrams, N_UTTS), tables, slots, sub_width))
    for path, (rows, (full, ctx_len, tables, slots, sub_width)) in cases.items():
        label = f"probe_rows {path} step"
        orders = len(tables)
        check(tuple(full.shape) == (rows, BEAM, orders + 1), f"{label}: ids are not [{rows}, {BEAM}, {orders + 1}]")
        got = gather.probe_rows(full, ctx_len, tables, slots, sub_width)
        torch.cuda.synchronize()
        want = gather.probe_rows_ref(full, ctx_len, tables, slots, sub_width)
        for name, g, w in zip(("found", "prob", "backoff"), got, want):
            check(g.dtype == w.dtype and tuple(g.shape) == (orders, rows, BEAM), f"{label}: bad {name} plane")
            check(torch.equal(g, w), f"{label}: {name} differs from the plain version")
        err = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))
        hits = [int(f.sum()) for f in got[0]]
        check(not path.endswith("seeded") or min(hits) > 0, f"{label}: an order's table was never hit")
        ms, call = time_call(torch, lambda: gather.probe_rows(full, ctx_len, tables, slots, sub_width))
        plain, plain_call = time_call(torch, lambda: gather.probe_rows_ref(full, ctx_len, tables, slots, sub_width))
        c_ms, _ = time_call(torch, lambda: gather.probe_rows(full, ctx_len, tables, slots, sub_width), flush=flush)
        c_plain, _ = time_call(torch, lambda: gather.probe_rows_ref(full, ctx_len, tables, slots, sub_width),
                               flush=flush)
        # ids and context lengths read once, each distinct bucket row read once
        # per order, (found, prob, backoff) written once per query and order
        moved = nbytes([full, ctx_len]) + nbytes(got)
        distinct = []
        for t, tab in enumerate(tables):
            h = gather.query_hashes(tab, full[..., orders - 1 - t:])[0] % tab["size"]
            distinct.append(int(h.unique().numel()))
            moved += distinct[-1] * tab["bucket"].shape[1] * tab["bucket"].element_size()
        q = ctx_len.numel()
        # per query and order: the three hashes (FNV-1a: 3 ops an id a lane; KenLM: ~10 integer
        # ops a chain step and ~10 a mix32_pair) and ~40 for the readout
        ops = sum(3.0 * 3 * (t + 2) if tab.get("hash_mode", "fnv") == "fnv" else 10.0 * (t + 1) + 30.0
                  for t, tab in enumerate(tables))
        b_ms, b_by = bound_ms(moved, (ops + 40.0 * orders) * q)
        log(f"{label}: ids {list(full.shape)}, {orders} tables, distinct bucket rows {distinct}, hits {hits}: "
            f"exact; kernel {ms:.4f} ms (call {call:.4f}), plain {plain:.4f} ms (call {plain_call:.4f}), "
            f"L2 flushed: kernel {c_ms:.4f} ms, plain {c_plain:.4f} ms; bound {b_ms:.5f} ms ({b_by})")
        rec[path] = dict(ms=ms, plain_ms=plain, library_ms=None, bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
                         shape=[list(full.shape), [list(tab["bucket"].shape) for tab in tables]],
                         call_ms=call, plain_call_ms=plain_call, cold_ms=c_ms, cold_plain_ms=c_plain,
                         hits=hits, distinct_rows=distinct)
    return rec


def reference_site(rel_path: str, line: int) -> str:
    """``<package>/<rel_path>:<line>`` of the JAX package's kernel this replaces.

    The reference package is found on disk (the one sibling package holding
    ``rel_path``); it is never imported.
    """
    root = os.path.dirname(os.path.abspath(__file__))
    for entry in sorted(os.listdir(root)):
        if entry != "pyctcdecode_torch" and os.path.isfile(os.path.join(root, entry, rel_path)):
            return f"{entry}/{rel_path}:{line}"
    return f"{rel_path}:{line}"


def parity_lm(build_dir: str, name: str = "parity_3gram.arpa", **sizes):
    """The parity-scale 3-gram ``name`` under ``build_dir`` (written from seed 7 when absent), and its vocabulary."""
    from pyctcdecode_torch.evaluation import LM_VOCAB, make_parity_arpa, parity_vocab

    path = os.path.join(build_dir, name)
    if os.path.exists(path):
        return path, parity_vocab(np.random.RandomState(7), LM_VOCAB)
    tmp = path + f".tmp{os.getpid()}"
    vocab = make_parity_arpa(tmp, **sizes)
    os.replace(tmp, path)
    return path, vocab


def segments_case(tag: str, decoder, members, logits, kw: dict, steps: list, wrappers: dict,
                  seg_values=(0, SEG)) -> dict:
    """One path with ``segment_frames`` 0 (the eager loop) and ``SEG`` (captured graphs), in turns.

    Each value runs on its own clone of ``decoder`` (``with_options``: the
    same device tables, no graph yet). The first call captures each graph
    key (the eager first segment, then the capture); its launch counts must
    equal ``expected_counts`` for ``steps`` (the call's decodes' step
    counts, one a length group; graphs pad each to whole segments). A warm
    call (replays only) must launch as much and give the first call's
    results. The graphs' results must equal the eager loop's: texts,
    frames, LM states, ``lm_score`` difference 0. Returns each value's
    results.
    """
    from pyctcdecode_torch.utils import profiling

    beams = {}
    for seg in seg_values:
        dec = decoder.with_options(segment_frames=seg)
        reset_counts(wrappers)
        with profiling.tracing() as tr:
            first = dec.decode_beams_batch(logits, **kw)
        launches = read_counts(wrappers)
        n_steps = sum(launched(n, seg) for n in steps)
        check_counts(f"{tag} segment_frames={seg}", launches, expected_counts(members, n_steps, len(steps)))
        captures = [s for s in tr.spans if s.name == "graph.capture" and s.note == "segment"]
        check((len(captures) > 0) == (seg > 0) and all(g.graph is not None for g in dec._graphs.values()),
              f"{tag} segment_frames={seg}: the decode did not run through captured graphs")
        reset_counts(wrappers)
        beams[seg] = dec.decode_beams_batch(logits, **kw)
        check(read_counts(wrappers) == launches, f"{tag} segment_frames={seg}: a warm call launched otherwise")
        check_same_results(f"{tag} segment_frames={seg} warm vs first", first, beams[seg], 0.0)
        del dec
    for seg in seg_values[1:]:
        check_same_results(f"{tag}: segment_frames={seg} vs the eager loop", beams[seg_values[0]], beams[seg], 0.0)
    log(f"[segments] {tag}: segment_frames {', '.join(map(str, seg_values))}: launch counts as the code implies, "
        f"a warm call as the first; the results equal to the bit")
    return beams


def tail_case(torch, tag: str, decoder, logits, kw: dict) -> dict:
    """:func:`_tail_case` in inference mode, as the decoder's own calls run (the graphs' buffers are inference tensors)."""
    with torch.inference_mode():
        return _tail_case(torch, tag, decoder, logits, kw)


def _tail_case(torch, tag: str, decoder, logits, kw: dict) -> dict:
    """The end of one graph decode (its first length group), eager against captured.

    The decode runs once through the graphs (``segment_frames=SEG``, the
    captures), recording its launch arguments; its segments are replayed
    again into logs owned here. Then, on the state the segments left:
    *before*, the finalize run eagerly (``_ranked_outputs`` on the host
    vector) and the plain backtrace (four launches a step); *after*, the
    finalize graph's replay with the copies out of its static buffers and
    one ``backtrace_paths`` launch. The two tails must give the same outputs
    to the bit. Returns the backtrace kernel's arguments: the logs with the
    full ranking (R = B) and with the decode's own (``top_n``).
    """
    import dataclasses

    from pyctcdecode_torch import engine
    from pyctcdecode_torch import torch_decoder as td
    from pyctcdecode_torch.ops.backtrace import backtrace_paths, backtrace_paths_ref

    dec = decoder.with_options(segment_frames=SEG)
    seen = []
    run_segmented = td.TorchBeamSearchDecoderCTC._run_segmented

    def recording(self, *args):
        seen.append(args)
        return run_segmented(self, *args)

    td.TorchBeamSearchDecoderCTC._run_segmented = recording
    try:
        dec.decode_beams_batch(logits, **kw)
    finally:
        td.TorchBeamSearchDecoderCTC._run_segmented = run_segmented
    cfg, seg, tables, dev_in, n_frames, params, start, hot = seen[0]
    init_fn, seg_fn, _ = engine.make_segment_decode_fns(cfg, tables, seg)
    n, t_pad = n_frames.shape[0], (dev_in[2] if cfg.token_timeline else dev_in).shape[1]
    prm = torch.as_tensor(params, device=dec.device)
    parents = torch.empty((n, t_pad, cfg.beam_width), dtype=engine._parent_dtype(cfg.beam_width), device=dec.device)
    trace = torch.empty((n, t_pad, cfg.beam_width), dtype=engine._path_dtype(cfg.vocab_size), device=dec.device)

    def seg_in(s):
        cut = slice(s * seg, (s + 1) * seg)
        return tuple(p[:, cut] for p in dev_in) if cfg.token_timeline else dev_in[:, cut]

    state0 = init_fn(start, n)
    graph = dec._segment_graph(cfg, seg, seg_fn, state0, seg_in(0), n_frames, prm, tables, hot)
    check(graph.graph is not None, f"tail {tag}: the decode's segment graph was not captured")
    state = engine.run_segments(seg_fn, seg, state0, seg_in, t_pad // seg, n_frames, prm, hot, parents, trace, graph)
    fin_graph = dec._finalize_graph(graph, cfg, tables, params)
    check(fin_graph.graph is not None, f"tail {tag}: the decode's finalize graph was not captured")

    before = engine._ranked_outputs(cfg, tables["lms"], hot, engine._params_dict(cfg, params), state)
    before["paths"] = backtrace_paths_ref(parents, trace, before["beam_src"].contiguous())
    after = {key: val.clone() for key, val in fin_graph.run().items()}
    after["paths"] = backtrace_paths(parents, trace, after["beam_src"])
    torch.cuda.synchronize()
    for key, val in before.items():
        check(torch.equal(val, after[key]), f"tail {tag}: {key} differs between the eager and the captured tail")
    log(f"[tail] {tag} ({n} rows, {t_pad} steps, R {int(after['paths'].shape[1])}): the eager finalize and plain "
        f"backtrace equal the finalize graph's replay and backtrace_paths to the bit")
    # the full ranking's source rows (R = B) for the kernel checks
    src_full = engine._ranked_outputs(dataclasses.replace(cfg, emit_paths=None), tables["lms"], hot,
                                      engine._params_dict(cfg, params), state)["beam_src"].contiguous()
    del dec
    return {"full": (parents, trace, src_full), "top": (parents, trace, after["beam_src"])}


def backtrace_phase(torch, cases: dict, card: str) -> dict:
    """``backtrace_paths`` against its plain version on real decodes' logs, bit-exact, and timed.

    ``cases``: name -> ``(parents, trace, src)`` on the card. Device ms over
    ``REPS`` calls (``time_call``), the plain version's over 5 (a launch
    chain of four ops a step). Bound: the bytes this run's chains need over
    the card's memory rate: each log entry a chain stands on read once
    (:func:`chain_entries`: at most ``min(R, B)`` a frame, fewer where
    chains merge), ``src`` read once, the paths written once.
    """
    from pyctcdecode_torch.ops.backtrace import backtrace_paths, backtrace_paths_ref

    out = {}
    for name, (parents, trace, src) in cases.items():
        got = backtrace_paths(parents, trace, src)
        want = backtrace_paths_ref(parents, trace, src)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"backtrace_paths {name}: differs from its plain version")
        ms, call_ms = time_call(torch, lambda: backtrace_paths(parents, trace, src))
        plain_ms, _ = time_call(torch, lambda: backtrace_paths_ref(parents, trace, src), reps=5)
        entries = chain_entries(torch, parents, src)
        moved = entries * (parents.element_size() + trace.element_size()) + nbytes([src, got])
        whole = nbytes([parents, trace, src, got])
        bound, by = bound_ms(moved, float(got.numel()))
        carry = int((trace == -3).sum())
        out[name] = {"shape": [list(parents.shape), str(parents.dtype), str(trace.dtype), list(src.shape)],
                     "ms": ms, "call_ms": call_ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                     "library_ms": None, "max_abs_err": 0.0, "bytes": moved, "log_entries_read": entries,
                     "whole_logs_bytes": whole, "whole_logs_bound_ms": bound_ms(whole, 0.0)[0],
                     "carry_markers": carry}
        log(f"[backtrace_paths] {name}: logs {list(parents.shape)} ({parents.dtype}, {trace.dtype}), R {src.shape[1]}"
            f"{f', {carry} carry markers' if carry else ''}: equal to the plain version; {ms:.4f} ms (call "
            f"{call_ms:.4f}), plain {plain_ms:.4f} ms, bound {bound:.6f} ms ({by}, {moved} bytes: {entries} log "
            f"entries the chains read, src, paths; the whole logs would be {whole} bytes, "
            f"{out[name]['whole_logs_bound_ms']:.6f} ms) [{card}]")
    return out


def record_replay(torch, decoder, logits, step: int, **decode_kw):
    """The arguments ``replay_winners`` gets at step ``step`` of a real decode (the eager loop)."""
    from pyctcdecode_torch import engine

    replay, seen, kept = engine.replay_winners, [0], []

    def recorder(*args):
        if seen[0] == step:
            kept.append(args)
        seen[0] += 1
        return replay(*args)

    engine.replay_winners = recorder
    try:  # on the eager loop: a captured segment's replay calls no wrapper
        decoder.with_options(segment_frames=0).decode_beams_batch(logits, beam_width=BEAM, **decode_kw)
    finally:
        engine.replay_winners = replay
    torch.cuda.synchronize()
    check(len(kept) == 1, f"a decode of {seen[0]} steps did not reach step {step}")
    return kept[0]


def replay_phase(torch, cases: dict, card: str) -> dict:
    """``replay_winners`` against its plain version on real steps' arguments, bit-exact, and timed.

    ``cases``: name -> the arguments ``record_replay`` kept. Device ms over
    ``REPS`` calls (``time_call``), the plain version's over 5. Bound: the
    bytes the replay needs over the card's memory rate: every state and
    commit plane read once, each winner's ranked entry, candidate (``src``,
    ``merged``, token) and trie entries once, the token tables once, every
    output plane written once.
    """
    from pyctcdecode_torch.ops.replay import replay_winners, replay_winners_ref

    out = {}
    for name, args in cases.items():
        before = replay_winners.launches
        got = replay_winners(*args)
        want = replay_winners_ref(*args)
        torch.cuda.synchronize()
        check(replay_winners.launches == before + 1, f"replay_winners {name}: not one launch")
        for key, val in want[0].items():
            check(torch.equal(got[0][key], val), f"replay_winners {name}: {key} differs from its plain version")
        for g, w, what in zip(got[1:], want[1:], ("parent", "token", "flags")):
            check((g is None and w is None) or (g.dtype == w.dtype and torch.equal(g, w)),
                  f"replay_winners {name}: {what} differs from its plain version")
        ms, call_ms = time_call(torch, lambda: replay_winners(*args))
        plain_ms, _ = time_call(torch, lambda: replay_winners_ref(*args), reps=5)
        state, cm, tok, win = args[:4]
        n, b = state["logit"].shape
        per_winner = [t for key, t in win.items() if key in ("order", "score") and t is not None]
        moved = (nbytes(list(state.values()) + list(cm.values()) + list(tok.values()) + list(got[0].values())
                     + [got[1], got[2]])
                 + sum(t.element_size() for t in per_winner) * n * b
                 + n * b * (4 + 4 + 8 + 8 * (len(win["ent"]) + (win.get("h_ent") is not None))))
        bound, by = bound_ms(moved, 0.0)
        out[name] = {"shape": [n, b, int(win["toks"].shape[1]), int(tok["raw_chars"].shape[1])],
                     "ms": ms, "call_ms": call_ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                     "library_ms": None, "max_abs_err": 0.0, "bytes": moved}
        log(f"[replay_winners] {name}: [{n}, {b}], K {win['toks'].shape[1]}, lmax {tok['raw_chars'].shape[1]}, "
            f"{len(win['ent'])} member(s): equal to the plain version; {ms:.4f} ms (call {call_ms:.4f}), plain "
            f"{plain_ms:.4f} ms, bound {bound:.6f} ms ({by}, {moved} bytes) [{card}]")
    return out


def record_commit(torch, decoder, logits, step: int, **decode_kw):
    """The arguments ``commit_words`` gets at step ``step`` of a real decode (the eager loop), cloned."""
    from pyctcdecode_torch import engine

    commit, seen, kept = engine.commit_words, [0], []

    def recorder(lms, prm, state, trie_rows, *flags):
        if seen[0] == step:
            kept.append((lms, prm, {key: val.clone() for key, val in state.items()},
                         [rows.clone() for rows in trie_rows], *flags))
        seen[0] += 1
        return commit(lms, prm, state, trie_rows, *flags)

    engine.commit_words = recorder
    try:  # on the eager loop: a captured segment's replay calls no wrapper
        decoder.with_options(segment_frames=0).decode_beams_batch(logits, beam_width=BEAM, **decode_kw)
    finally:
        engine.commit_words = commit
    torch.cuda.synchronize()
    check(len(kept) == 1, f"a decode of {seen[0]} steps did not reach step {step}")
    return kept[0]


def commit_phase(torch, cases: dict, card: str) -> dict:
    """``commit_words`` against its plain version on real steps' arguments, bit-exact, and timed.

    ``cases``: name -> the arguments ``record_commit`` kept. Device ms over
    ``REPS`` calls (``time_call``), the plain version's (the composition the
    step ran before, its probe the ``probe_rows`` kernel) over 5. Bound: the
    bytes the commit needs over the card's memory rate: every state plane it
    reads and every output written once, each member's trie rows' last four
    words, and one 512-byte bucket row per beam and probe table.
    """
    from pyctcdecode_torch.ops.commit import commit_words, commit_words_ref

    out = {}
    for name, args in cases.items():
        lms, prm, state, trie_rows, use_hot, stats = args
        before = commit_words.launches
        got = commit_words(*args)
        want = commit_words_ref(*args)
        torch.cuda.synchronize()
        check(commit_words.launches == before + 1, f"commit_words {name}: not one launch")
        check(sorted(got) == sorted(want), f"commit_words {name}: other outputs than its plain version's")
        for key, val in want.items():
            if key == "probe_hits":
                same = all(torch.equal(g, w) for gm, wm in zip(got[key], val) for g, w in zip(gm, wm))
            else:
                same = got[key].dtype == val.dtype and torch.equal(got[key], val)
            check(same, f"commit_words {name}: {key} differs from its plain version")
        ms, call_ms = time_call(torch, lambda: commit_words(*args))
        plain_ms, _ = time_call(torch, lambda: commit_words_ref(*args), reps=5)
        n, b = state["p_len"].shape
        keys = ["text_lo", "text_hi", "p_lo", "p_hi", "p_len"] + (["h_bits"] if use_hot else [])
        keys += [f"{k}{i}" for i in range(len(lms)) for k in ("p_flags", "ctx", "ctx_len", "ctx_bo")]
        tables = sum(len(lm["fp"]) for lm in lms)
        written = [t for key, t in got.items() if key != "probe_hits"]
        moved = (nbytes([state[k] for k in keys] + written) + n * b * (16 * len(lms) + 512 * tables)
                 + (n * b * sum(lm["order"] for lm in lms) if stats else 0))
        bound, by = bound_ms(moved, 0.0)
        out[name] = {"shape": [n, b, len(lms), tables], "ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
                     "bound_ms": bound, "bound_by": by, "library_ms": None, "max_abs_err": 0.0, "bytes": moved,
                     "commits": int((state["p_len"] > 0).sum())}
        log(f"[commit_words] {name}: [{n}, {b}], {len(lms)} member(s), {tables} table(s), hotwords {use_hot}, "
            f"stats {stats}: equal to the plain version; {ms:.4f} ms (call {call_ms:.4f}), plain {plain_ms:.4f} ms, "
            f"bound {bound:.6f} ms ({by}, {moved} bytes) [{card}]")
    return out


def record_walk(torch, run, step: int):
    """The arguments ``walk_partial`` gets at its ``step``-th call while ``run()`` decodes on the eager loop, cloned."""
    from pyctcdecode_torch import engine

    walk, seen, kept = engine.walk_partial, [0], []

    def recorder(lms, hot, prm, state, toks, tok, trie_rows, is_bpe):
        if seen[0] == step:
            kept.append((lms, hot, prm, {key: val.clone() for key, val in state.items()}, toks.clone(), tok,
                         [rows.clone() for rows in trie_rows], is_bpe))
        seen[0] += 1
        return walk(lms, hot, prm, state, toks, tok, trie_rows, is_bpe)

    engine.walk_partial = recorder
    try:  # on the eager loop: a captured segment's replay calls no wrapper
        run()
    finally:
        engine.walk_partial = walk
    torch.cuda.synchronize()
    check(len(kept) == 1, f"a decode of {seen[0]} steps did not reach step {step}")
    return kept[0]


def record_walk_batch(torch, decoder, logits, step: int, **decode_kw):
    """``record_walk`` over a batch decode of ``logits``."""
    eager = decoder.with_options(segment_frames=0)
    return record_walk(torch, lambda: eager.decode_beams_batch(logits, beam_width=BEAM, **decode_kw), step)


def record_walk_stream(torch, decoder, mat, step: int):
    """``record_walk`` over one stream of ``mat`` in ``STREAM_CHUNK``-frame chunks (N = 1 steps)."""
    eager = decoder.with_options(segment_frames=0)

    def run():
        state = eager.get_starting_state(beam_width=BEAM)
        for a in range(0, step + 1, STREAM_CHUNK):
            eager.partial_decode_beams(state, mat[a : a + STREAM_CHUNK])

    return record_walk(torch, run, step)


def w2v2_logits(logits) -> list:
    """The char corpus's logits in wav2vec2-base-960h's 32 columns; the markers at each frame's floor."""
    src = {"<pad>": "", "|": " "}
    out = []
    for m in logits:
        cols = [m[:, LIBRI_LABELS.index(src.get(lab, lab))] if src.get(lab, lab) in LIBRI_LABELS else m.min(axis=1)
                for lab in W2V2_LABELS]
        out.append(np.stack(cols, axis=1).astype(np.float32))
    return out


def walk_phase(torch, cases: dict, card: str) -> dict:
    """``walk_partial`` against its plain version on real steps' arguments, bit-exact, and timed.

    ``cases``: name -> the arguments ``record_walk`` kept. Device ms over
    ``REPS`` calls (``time_call``), back to back (warm) and with the L2
    cache flushed before each call; the plain version's (the composition the
    step ran before) over 5. Bound: the bytes the walk needs over the card's
    memory rate: the state planes, tokens, token tables, seeds and fetched
    trie rows read once, a 4-byte trie cell for every letter a walking
    candidate reads in each trie (members and the hot trie), and the outputs
    written once.
    """
    from pyctcdecode_torch.ops.walk import walk_partial, walk_partial_ref

    flush = make_flush(torch, torch.device("cuda"))
    out = {}
    for name, args in cases.items():
        lms, hot, prm, state, toks, tok, trie_rows, is_bpe = args
        before = walk_partial.launches
        got = walk_partial(*args)
        want = walk_partial_ref(*args)
        torch.cuda.synchronize()
        check(walk_partial.launches == before + 1, f"walk_partial {name}: not one launch")
        check(len(got[0]) == len(want[0]) == len(lms), f"walk_partial {name}: not one entry plane a member")
        for i, (g, w) in enumerate(zip(got[0], want[0])):
            check(g.dtype == w.dtype and torch.equal(g, w), f"walk_partial {name}: member {i}'s entries differ")
        check((got[1] is None and want[1] is None) or torch.equal(got[1], want[1]),
              f"walk_partial {name}: the hot entries differ from its plain version")
        check(got[2].dtype == want[2].dtype and torch.equal(got[2].view(torch.int32), want[2].view(torch.int32)),
              f"walk_partial {name}: the partial scores differ from its plain version (bits)")
        ms, call_ms = time_call(torch, lambda: walk_partial(*args))
        cold_ms, _ = time_call(torch, lambda: walk_partial(*args), flush=flush)
        plain_ms, _ = time_call(torch, lambda: walk_partial_ref(*args), reps=5)
        n, b = state["p_len"].shape
        k = toks.shape[1]
        kind = tok["kind"][toks][:, None, :]
        stay = (kind == 0) | (state["last_tok"][:, :, None] == toks[:, None, :])
        bnd = ~stay & ((kind == 1) | (state["force"][:, :, None] if is_bpe else False))
        letters = int(((~stay & ~bnd) * tok["raw_len"][toks][:, None, :]).sum())
        keys = ["last_tok", "p_len", "force"] + [f"{key}{i}" for i in range(len(lms)) for key in ("p_node", "p_flags")]
        keys += ["h_node", "h_bits"] if hot is not None else []
        tables = [tok[key] for key in ("kind", "piece_len", "raw_len", "raw_chars")] + [lm["seed_node"] for lm in lms]
        tables += [hot["seed"]] if hot is not None else []
        written = got[0] + ([got[1]] if got[1] is not None else []) + [got[2]]
        moved = (nbytes([state[key] for key in keys] + [toks] + tables + list(trie_rows) + written)
                 + 4 * letters * (len(lms) + (hot is not None)))
        bound, by = bound_ms(moved, 0.0)
        lmax = int(tok["raw_chars"].shape[1])
        out[name] = {"shape": [n, b, k, lmax, len(lms), hot is not None], "ms": ms, "cold_ms": cold_ms,
                     "call_ms": call_ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by, "library_ms": None,
                     "max_abs_err": 0.0, "bytes": moved, "letters_walked": letters}
        log(f"[walk_partial] {name}: [{n}, {b}, {k}], lmax {lmax}, {len(lms)} member(s), hotwords {hot is not None}, "
            f"{letters} letters walked: equal to the plain version; {ms:.4f} ms (L2 flushed {cold_ms:.4f}, call "
            f"{call_ms:.4f}), plain {plain_ms:.4f} ms, bound {bound:.6f} ms ({by}, {moved} bytes) [{card}]")
    return out


def chain_entries(torch, parents, src) -> int:
    """Log entries the chains of ``src`` stand on: per utterance and frame, the distinct beams among them."""
    cur = src
    total = torch.zeros((), dtype=torch.int64, device=src.device)
    for t in range(parents.shape[1] - 1, -1, -1):
        ranked, _ = cur.sort(dim=1)
        total += ranked.shape[0] + (ranked[:, 1:] != ranked[:, :-1]).sum()
        cur = parents[:, t].gather(1, cur).to(torch.int64)
    return int(total)


def pipelined(tag: str, decoder, members, logits, serve_kw: dict, serve_beams, wrappers: dict) -> dict:
    """``decode_beams_batches`` at depth 1 over the first ``PIPE_UTTS`` utterances and the same reversed.

    Checks the launch counts the two batches' serving plans imply, and that
    each batch's results are ``serve_beams``' (the serving call's, in that
    batch's order). Returns the launch counts.
    """
    from pyctcdecode_torch.constants import DEFAULT_MIN_TOKEN_LOGP

    logits, serve_beams = logits[:PIPE_UTTS], serve_beams[:PIPE_UTTS]
    stream = [logits, logits[::-1]]
    reset_counts(wrappers)
    piped = list(decoder.decode_beams_batches(stream, pipeline_depth=1, prune_history=True, top_n=1, **serve_kw))
    launches = read_counts(wrappers)
    check(len(piped) == len(stream), f"{tag}: decode_beams_batches gave not one result per batch")
    blank_id = decoder._labels.index("")
    plans = [serving_plan(decoder, b, blank_id, DEFAULT_MIN_TOKEN_LOGP) for b in stream]
    check_counts(f"{tag} pipelined", launches, expected_counts(
        members, sum(p["steps"] for p in plans), sum(len(p["groups"]) for p in plans)))
    for i, want in enumerate((serve_beams, serve_beams[::-1])):
        check_same_results(f"{tag} pipelined batch {i}", want, piped[i], RERUN_TOL)
    log(f"[{tag}] decode_beams_batches, the first {PIPE_UTTS} utterances and the same reversed at pipeline_depth 1: "
        f"the serving call's results")
    return launches


def counters(merge, gather) -> dict:
    from pyctcdecode_torch.ops import backtrace, commit, replay, walk

    return {"merge_prune": merge.merge_prune, "expand_merge_prune": merge.expand_merge_prune,
            "gather_rows": gather.gather_rows, "probe_rows": gather.probe_rows,
            "backtrace_paths": backtrace.backtrace_paths, "replay_winners": replay.replay_winners,
            "commit_words": commit.commit_words, "walk_partial": walk.walk_partial}


def reset_counts(wrappers: dict) -> None:
    for fn in wrappers.values():
        fn.launches = 0


def read_counts(wrappers: dict) -> dict:
    return {name: fn.launches for name, fn in wrappers.items()}


def expected_counts(members, steps: int, finalizes: int, stream: bool = False, sharded: bool = False) -> dict:
    """Launches that ``steps`` decode steps and ``finalizes`` finalizations imply.

    ``members``: the LM members (one for a plain LM, none without an LM).
    Every step launches ``expand_merge_prune``, ``walk_partial`` and
    ``replay_winners`` once,
    per member ``gather_rows`` once (the beams' trie rows), and the word
    commit: one ``commit_words`` launch for every member, or, over
    row-sharded tables (``sharded``), an order-1 member or more than 8 probe
    tables, the PyTorch composition, one ``probe_rows`` launch a member of
    order >= 2. A finalization launches ``merge_prune`` once and, per
    member, scores the last word and, where the member scores the sentence
    boundary, ``</s>``: one ``probe_rows`` launch each. A unigram member
    probes no table. A batch decode's finalization backtraces its paths
    with one ``backtrace_paths`` launch; a stream's chunk (``stream``)
    backtraces on the host.
    """
    probing = [m for m in members if m.order > 1]
    kernel = (not sharded and len(probing) == len(members) <= 8
              and sum(m.order - 1 for m in members) <= 8)
    return {
        "expand_merge_prune": steps,
        "merge_prune": finalizes,
        "gather_rows": steps * len(members),
        "probe_rows": (0 if kernel else steps * len(probing))
        + finalizes * sum(2 if m.score_boundary else 1 for m in probing),
        "backtrace_paths": 0 if stream else finalizes,
        "replay_winners": steps,
        "commit_words": steps if kernel else 0,
        "walk_partial": steps,
    }


def serving_plan(decoder, logits, blank_id: int, token_min_logp: float) -> dict:
    """What the serving call's host prep makes of ``logits``: frames kept by the
    blank collapse, the length groups, each group's virtual steps (its
    longest chunk timeline) and the steps it launches (padded to whole
    segments of the decoder's ``segment_frames``), from the package's host
    functions and the decoder's own grouping rule, to hold the launch
    counters against.
    """
    from pyctcdecode_torch.utils.logits import normalize_collapse_batch, token_timeline_batch

    mats, _, _ = normalize_collapse_batch(logits, blank_id, token_min_logp)
    lens = [max(m.shape[0], 1) for m in mats]
    groups = decoder._length_groups(mats, target_rows=SERVING["length_bucketing"])
    steps = []
    for idx in groups:
        _, vlens = token_timeline_batch([mats[i] for i in idx], token_min_logp, CHUNK)
        steps.append(max(int(max(vlens)), 1))
    seg = decoder._segment_frames_effective()
    return {"frames_in": int(sum(m.shape[0] for m in logits)),
            "frames_kept": int(sum(m.shape[0] for m in mats)),
            "longest_kept": max(lens), "groups": [len(g) for g in groups], "group_steps": steps,
            "virtual_steps": int(sum(steps)), "steps": int(sum(launched(n, seg) for n in steps)),
            "segment_frames": seg}


def launched(steps: int, seg: int = SEG) -> int:
    """Steps a decode of ``steps`` steps launches: whole segments of ``seg`` (0: the eager loop, ``steps``)."""
    return -(-steps // seg) * seg if seg else steps


def check_counts(tag: str, got: dict, want: dict) -> None:
    log(f"[{tag}] launches {got}, implied by the code {want}")
    for name, n in want.items():
        check(got[name] == n, f"{tag}: {name} launched {got[name]} times, expected {n}")
        check(got[name] > 0 or n == 0, f"{tag}: {name} was never launched")


def top_texts(beams) -> list:
    return [b[0].text if b else "" for b in beams]


def check_same_results(tag: str, want, got, tol: float) -> float:
    """Ranked beam lists per utterance: same texts, frames and LM states, scores within ``tol``."""
    check(len(want) == len(got), f"{tag}: {len(got)} results for {len(want)} utterances")
    worst = 0.0
    for i, (w, g) in enumerate(zip(want, got)):
        check(len(w) == len(g) and len(w) > 0, f"{tag}: utterance {i}: beam counts differ")
        for wb, gb in zip(w, g):
            check(wb.text == gb.text, f"{tag}: utterance {i}: texts differ")
            check(wb.text_frames == gb.text_frames, f"{tag}: utterance {i}: text_frames differ")
            check(wb.last_lm_state == gb.last_lm_state, f"{tag}: utterance {i}: last_lm_state differs")
            d = abs(wb.lm_score - gb.lm_score)
            worst = max(worst, d)
            check(d <= tol, f"{tag}: utterance {i}: lm_score differs by {d}")
    return worst


def hotword_list(references, vocab) -> list:
    """The ``hot2lm`` hotwords: 24 unigrams and 2 two-word phrases from the
    reference transcripts, and 2 spellable strings no LM knows (seeded)."""
    rng = np.random.RandomState(HOT_SEED)
    words = sorted({w for ref in references for w in ref.split()})
    unigrams = [str(w) for w in rng.choice(words, size=HOT_UNIGRAMS, replace=False)]
    phrases = []
    for i in rng.choice(len(references), size=HOT_PHRASES, replace=False):
        ref = references[i].split()
        j = rng.randint(0, len(ref) - 1)
        phrases.append(" ".join(ref[j : j + 2]))
    known = set(vocab)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz'"))
    unknown = []
    while len(unknown) < HOT_UNKNOWN:
        word = "".join(rng.choice(letters, size=13))
        if word not in known:
            unknown.append(word)
    return unigrams + phrases + unknown


def ngram_count(model, n: int) -> int:
    """Entries of order ``n`` of an n-gram model read in Python or by the native engine."""
    if hasattr(model, "tables"):
        return len(model.tables.ngrams[n - 1])
    return int(model.native.export_tables()[n - 1]["count"])


def hot2lm_phase(torch, P, gather, merge, lm_a, corpus, vocab, dense_wer: float):
    """The ``hot2lm`` path: two parity-scale 3-gram members and hotwords, dense and serving.

    Member A is ``lm_a``, the dense path's LM at its settings; member B is the
    parity 3-gram at half the bigrams and trigrams from the same seed (so
    the same 200k-word vocabulary), at ``alpha=0.3, beta=2.0,
    unk_score_offset=-6.0, score_boundary=False``. Checks: the vocabularies
    agree; member B's ``gather_rows`` / ``probe_rows`` on a real step are
    bit-exact against their plain versions (and timed); the launch counters
    equal the two members' ``expected_counts`` on the dense, serving and
    pipelined calls; serving texts equal dense texts; the first utterances,
    and those whose top text the hotwords change, agree with a CPU decode
    (``MultiLMState`` last states); graphs equal the eager loop. Logged: WER
    beside the single-LM path's, the top texts the hotwords change. Returns
    the record, the two-member decoder and the hotwords.
    """
    from pyctcdecode_torch.constants import DEFAULT_HOTWORD_WEIGHT, DEFAULT_MIN_TOKEN_LOGP
    from pyctcdecode_torch.csrc.build import BUILD_DIR
    from pyctcdecode_torch.evaluation import LM_BIGRAMS, LM_TRIGRAMS
    from pyctcdecode_torch.models.ngram import load_unigram_set_from_arpa, open_ngram_file
    from pyctcdecode_torch.utils.metrics import word_error_rate

    arpa_b, vocab_b = parity_lm(str(BUILD_DIR), "parity_3gram_half.arpa",
                                n_bigrams=LM_BIGRAMS // 2, n_trigrams=LM_TRIGRAMS // 2)
    check(vocab_b == vocab, "member B's vocabulary differs from member A's")
    lm_b = P.LanguageModel(open_ngram_file(arpa_b, backend="python"), load_unigram_set_from_arpa(arpa_b), **MEMBER_B)
    check(lm_b.unigram_set == lm_a.unigram_set, "member B's unigram set differs from member A's")
    n_bigrams = [ngram_count(m.ngram_model, 2) for m in (lm_a, lm_b)]
    check(lm_b.order == 3 and n_bigrams[1] < n_bigrams[0], "member B is not the half-size 3-gram")
    members = [lm_a, lm_b]
    alphabet = P.Alphabet.build_alphabet(LIBRI_LABELS)
    multi = P.TorchBeamSearchDecoderCTC(alphabet, P.MultiLanguageModel(members))
    check(multi.device.type == "cuda" and len(multi._tabs["lms"]) == 2, "the two-member decoder is not on CUDA")
    sizes = [[tab["size"] for tab in tabs["fp"]] for tabs in multi._tabs["lms"]]
    check(sizes[0] != sizes[1], "the two members' bucket tables have the same sizes")
    hot = hotword_list(corpus.references, vocab)
    hot_kw = dict(hotwords=hot, hotword_weight=DEFAULT_HOTWORD_WEIGHT)
    logits = corpus.logits
    t_max = max(m.shape[0] for m in logits)
    log(f"[hot2lm] member B {os.path.basename(arpa_b)} (bucket rows per order {sizes[1]} against A's "
        f"{sizes[0]}); {len(hot)} hotwords: {hot}")

    # member B's kernels on a real step's nodes and queries
    head = [m[:61] for m in logits]
    step_b = {"hot2lm member B dense": (N_UTTS, record_step_reads(
        torch, multi, head, step=60, member=1, **hot_kw))}
    b_gather = gather_phases(torch, gather, step_b, synthetic=False)
    b_probe = probe_phases(torch, gather, step_b)
    del step_b

    wrappers = counters(merge, gather)
    dense_kw = dict(beam_width=BEAM, max_tokens_per_frame=None, **hot_kw)
    beams_kw = dict(prune_history=True, top_n=1)
    reset_counts(wrappers)
    texts = multi.decode_batch(logits, **dense_kw)
    launches = read_counts(wrappers)
    check_counts("hot2lm dense", launches, expected_counts(members, launched(t_max), 1))
    dense_beams = multi.decode_beams_batch(logits, **dense_kw, **beams_kw)
    check(top_texts(dense_beams) == texts, "hot2lm: repeated dense decode gave other texts")
    check(all(isinstance(b[0].last_lm_state, P.MultiLMState) for b in dense_beams),
          "hot2lm: a last_lm_state is not a MultiLMState")
    wer = word_error_rate(corpus.references, texts)
    plain_kw = dict(beam_width=BEAM, max_tokens_per_frame=None)
    reset_counts(wrappers)
    plain_texts = multi.decode_batch(logits, **plain_kw)
    check_counts("hot2lm dense, no hotwords", read_counts(wrappers), expected_counts(members, launched(t_max), 1))
    changed_at = [i for i, (a, b) in enumerate(zip(texts, plain_texts)) if a != b]
    wer_plain = word_error_rate(corpus.references, plain_texts)
    log(f"[hot2lm] dense decode_batch {N_UTTS} x beam {BEAM}, K {K_TOKENS}, 2 members + hotwords: WER {wer:.4f} "
        f"(single LM {dense_wer:.4f}, the two members without hotwords {wer_plain:.4f}); the hotwords change "
        f"{len(changed_at)} of {N_UTTS} top texts (utterances {changed_at})")

    blank_id = LIBRI_LABELS.index("")
    plan = serving_plan(multi, logits, blank_id, DEFAULT_MIN_TOKEN_LOGP)
    serve_kw = dict(beam_width=BEAM, **SERVING, **hot_kw)
    reset_counts(wrappers)
    s_texts = multi.decode_batch(logits, **serve_kw)
    s_launches = read_counts(wrappers)
    check_counts("hot2lm serving", s_launches, expected_counts(members, plan["steps"], len(plan["groups"])))
    check(s_texts == texts, "hot2lm: the serving decode's texts differ from the dense decode's")
    serve_beams = multi.decode_beams_batch(logits, **serve_kw, **beams_kw)
    d_score = check_same_results("hot2lm serving vs dense", dense_beams, serve_beams, LM_SCORE_TOL)
    log(f"[hot2lm] serving decode_batch, chunks of {CHUNK}, collapse, {len(plan['groups'])} groups: texts, "
        f"text_frames and states equal the dense path's, max lm_score diff {d_score:.3g}")

    piped = pipelined("hot2lm", multi, members, logits, serve_kw, serve_beams, wrappers)

    cpu = P.TorchBeamSearchDecoderCTC(alphabet, P.MultiLanguageModel(members), device="cpu")
    # the first utterances, and the first whose top text the hotwords change
    checked = sorted(set(range(CPU_CHECK)) | set(changed_at[:HOT_CPU_CHANGED]))
    sub = [logits[i][:CPU_FRAMES] for i in checked]
    kw = dict(dense_kw, batch_pad=1)
    max_d = check_same_results("hot2lm: GPU vs CPU", cpu.decode_beams_batch(sub, **kw, **beams_kw),
                               multi.decode_beams_batch(sub, **kw, **beams_kw), LM_SCORE_TOL)
    log(f"[check] hot2lm dense: the first {CPU_FRAMES} frames of utterances {checked} identical on the CPU, texts, "
        f"text_frames and MultiLMState last states (max lm_score diff {max_d:.3g})")
    del cpu

    segments_case("hot2lm dense", multi, members, logits, dict(dense_kw, **beams_kw), [t_max], wrappers)
    record = {
        "members": [dict(order=m.order, alpha=m.alpha, beta=m.beta, unk_score_offset=m.unk_score_offset,
                         score_boundary=m.score_boundary) for m in members],
        "bucket_rows": sizes, "hotwords": hot, "hotword_weight": DEFAULT_HOTWORD_WEIGHT,
        "frame_steps": t_max, "launches": launches,
        "wer": wer, "wer_without_hotwords": wer_plain, "texts_changed_at": changed_at,
        "serving": dict(plan, launches=s_launches, max_lm_score_diff_vs_dense=d_score, pipelined_launches=piped),
        "cpu_checked": checked, "cpu_max_lm_score_diff": max_d,
        "gather_member_b": b_gather["hot2lm member B dense step: trie rows"],
        "probe_member_b": b_probe["hot2lm member B dense"],
    }
    return record, multi, hot


def bpe_vocabulary(words) -> list:
    """The bpe path's 128 raw labels, grown from ``words``.

    ``<unk>`` (the alphabet makes it ``▁⁇▁``, bounded on the right) and
    ``▁``; the 26 letters and the 26 ``▁``-letter pieces; for each length of
    2-4 letters, the ``BPE_QUOTA`` most frequent word-initial substrings of
    ``words``, ``▁``-prefixed, and as many of the most frequent inner ones
    (ties broken by the string): 37 + 37. Counted by length, since over
    random words a shorter substring is always the more frequent. The
    alphabet appends the blank.
    """
    from collections import Counter

    first = {n: Counter() for n in BPE_QUOTA}
    inner = {n: Counter() for n in BPE_QUOTA}
    for word in words:
        for n in BPE_QUOTA:
            for i in range(len(word) - n + 1):
                (first if i == 0 else inner)[n][word[i : i + n]] += 1

    def top(counts, m):
        return sorted(counts, key=lambda piece: (-counts[piece], piece))[:m]

    letters = list("abcdefghijklmnopqrstuvwxyz")
    multi = []
    for n, m in BPE_QUOTA.items():
        multi += ["▁" + piece for piece in top(first[n], m)] + top(inner[n], m)
    return ["<unk>", "▁"] + letters + ["▁" + c for c in letters] + multi


def split_pieces(word: str, index: dict) -> list:
    """Greedy longest-match piece ids of ``word``, the first piece ``▁``-prefixed."""
    ids, i = [], 0
    while i < len(word):
        for n in range(min(4, len(word) - i), 0, -1):
            piece = ("▁" if i == 0 else "") + word[i : i + n]
            if piece in index:
                ids.append(index[piece])
                i += n
                break
        else:
            raise CheckFailed(f"bpe: {word!r} cannot be split into the vocabulary's pieces")
    return ids


def bpe_corpus(references, labels) -> list:
    """Logits of ``references`` over the piece alphabet ``labels`` (normalized, blank included).

    ``synthesize_corpus``'s noise model at dev-other difficulty, one piece per
    emission: each piece of a word's split holds 1-2 frames and is followed by
    1-2 blank frames; raw logits are ``peak`` one-hot + N(0, ``noise``), blank
    frames ``blank_peak``. Seeded with ``BPE_SEED``.
    """
    from pyctcdecode_torch.evaluation import DEV_OTHER_DIFFICULTY

    d = DEV_OTHER_DIFFICULTY
    index = {lab: i for i, lab in enumerate(labels)}
    blank = index[""]
    rng = np.random.RandomState(BPE_SEED)
    mats = []
    for ref in references:
        ids = []
        for word in ref.split():
            for piece in split_pieces(word, index):
                ids += [piece] * rng.randint(d["frames_per_char"][0], d["frames_per_char"][1] + 1)
                ids += [blank] * rng.randint(d["blank_frames"][0], d["blank_frames"][1] + 1)
        arr = np.asarray(ids)
        mat = rng.randn(len(ids), len(labels)).astype(np.float32) * d["noise"]
        mat[np.arange(len(ids)), arr] += d["peak"]
        mat[arr == blank, blank] += d["blank_peak"] - d["peak"]
        mats.append(mat)
    return mats


def greedy_bpe(logits, labels) -> list:
    """Best-path texts: each frame's argmax piece, replayed by the piece rules."""
    from pyctcdecode_torch.torch_decoder import replay_token_path

    texts = []
    for mat in logits:
        words, _, (partial, _) = replay_token_path(mat.argmax(axis=1).tolist(), labels, True)
        texts.append(" ".join(words + ([partial] if partial else [])))
    return texts


def record_expand_step(torch, decoder, logits, step: int, **decode_kw):
    """The arguments ``expand_merge_prune`` gets in one real decode step (``decode_batch``
    of ``logits`` with ``decode_kw``; ``step`` counts from the call's first decode)."""
    from pyctcdecode_torch import engine

    wrapper, calls = engine.expand_merge_prune, []

    def recorder(*args):
        if len(calls) == step:
            calls.append(tuple({k: v.clone() for k, v in a.items()} if isinstance(a, dict) else
                               a.clone() if isinstance(a, torch.Tensor) else a for a in args))
        elif len(calls) < step:
            calls.append(None)
        return wrapper(*args)

    engine.expand_merge_prune = recorder
    try:  # on the eager loop: a captured segment's replay calls no wrapper
        decoder.with_options(segment_frames=0).decode_batch(logits, beam_width=BEAM, **decode_kw)
    finally:
        engine.expand_merge_prune = wrapper
    torch.cuda.synchronize()
    check(len(calls) > step, "fewer expand_merge_prune calls than steps were recorded")
    return calls[step]


def bpe_phase(torch, P, merge, gather, lm_a, members, hot, corpus, vocab):
    """The ``bpe`` path: a 128-piece vocabulary on the dense and serving decode.

    The pieces come from :func:`bpe_vocabulary` over the parity LM's words
    (V = 129 with the blank, ``▁⁇▁`` bounded on the right, labels up to
    ``▁`` + 4 letters); the logits from :func:`bpe_corpus` over the same 32
    references. Member A (``lm_a``) is the LM; one more dense decode runs
    ``members`` (the hot2lm path's two) with the hotwords ``hot``. Checks:
    ``expand_merge_prune`` in its BPE form on a real dense and serving step
    against its plain version; the launch counts of the dense, serving,
    pipelined and two-member calls; serving and pipelined texts equal the
    dense texts; the first ``CPU_CHECK`` utterances decode identically on
    the CPU, dense, with member A and with the two members and hotwords;
    graphs equal the eager loop, the captured end of a decode the eager one.
    Returns the decoder, the logits and the record.
    """
    from pyctcdecode_torch.constants import DEFAULT_MIN_TOKEN_LOGP
    from pyctcdecode_torch.utils.metrics import word_error_rate

    raw = bpe_vocabulary(vocab)
    alphabet = P.Alphabet.build_alphabet(raw)
    labels = alphabet.labels
    decoder = P.TorchBeamSearchDecoderCTC(alphabet, lm_a)
    lmax = int(decoder._tabs["tok"]["raw_chars"].shape[1])
    check(alphabet.is_bpe and len(set(raw)) == 128 and len(labels) == BPE_V and lmax == BPE_LMAX,
          f"bpe: the vocabulary is not 128 pieces + blank with labels of up to {BPE_LMAX} chars")
    check(decoder.device.type == "cuda" and labels[0] == "▁⁇▁" and labels[-1] == "", "bpe: bad decoder")
    logits = bpe_corpus(corpus.references, labels)
    steps = max(m.shape[0] for m in logits)
    index = {lab: i for i, lab in enumerate(labels)}
    pieces = sum(len(split_pieces(w, index)) for ref in corpus.references for w in ref.split())
    log(f"[bpe] {len(labels)} columns ({sum(lab.startswith('▁') for lab in labels)} ▁-pieces, lmax {lmax}): "
        f"{labels[:8]} ... {labels[-6:]}; {N_UTTS} utterances, {pieces} pieces for "
        f"{sum(len(r.split()) for r in corpus.references)} words, frames {min(m.shape[0] for m in logits)}.."
        f"{steps} at {BPE_FRAME_SEC} s a frame")

    # expand_merge_prune in its BPE form on a real step of each path (the warm-up
    # decodes), at every cluster size; its times are the kernel phase's
    blank_id = labels.index("")
    head = [m[:61] for m in logits]
    head_plan = serving_plan(decoder, head, blank_id, DEFAULT_MIN_TOKEN_LOGP)
    step_rec = {}
    for path, eargs in (
            ("dense", record_expand_step(torch, decoder, head, 60)),
            ("serving", record_expand_step(torch, decoder, head, head_plan["group_steps"][0] // 2, **SERVING))):
        check(eargs[5] is True and eargs[2].shape[0] == BPE_LMAX, f"bpe {path} step: not the kernel's BPE form")
        label = f"expand_merge_prune bpe {path} step {list(eargs[3].shape)} lmax={BPE_LMAX}"
        want = merge.expand_merge_prune_ref(*eargs)
        err = max(compare(f"{label} cluster={c}", merge.expand_merge_prune(*eargs, cluster=c), want, eargs[4])
                  for c in (0,) + CLUSTERS)
        alive = eargs[0]["logit"] > -1e29
        n_valid = int((alive[:, None, :] & (eargs[1]["admit"][:, :, None] != 0)).sum())
        log(f"{label}: {n_valid} valid candidates, {int((eargs[0]['force'] != 0).sum())} beams after a "
            f"right-bounded piece; equal to the plain version at every cluster size, max_abs_err {err:.3g}")
        step_rec[path] = dict(shape=list(eargs[3].shape), max_abs_err=err, n_valid=n_valid)
        del eargs, want

    wrappers = counters(merge, gather)
    dense_kw = dict(beam_width=BEAM, max_tokens_per_frame=None)
    beams_kw = dict(prune_history=True, top_n=1)
    reset_counts(wrappers)
    texts = decoder.decode_batch(logits, **dense_kw)
    launches = read_counts(wrappers)
    check_counts("bpe dense", launches, expected_counts([lm_a], launched(steps), 1))
    dense_beams = decoder.decode_beams_batch(logits, **dense_kw, **beams_kw)
    check(top_texts(dense_beams) == texts, "bpe: repeated dense decode gave other texts")
    wer = word_error_rate(corpus.references, texts)
    wer_greedy = word_error_rate(corpus.references, greedy_bpe(logits, labels))
    forced = sum("⁇" in t for t in texts)
    log(f"[bpe] dense decode_batch {N_UTTS} x beam {BEAM}, K {BPE_V}: WER {wer:.4f} (greedy {wer_greedy:.4f}); "
        f"{forced} top texts hold the unknown piece")

    plan = serving_plan(decoder, logits, blank_id, DEFAULT_MIN_TOKEN_LOGP)
    serve_kw = dict(beam_width=BEAM, **SERVING)
    reset_counts(wrappers)
    s_texts = decoder.decode_batch(logits, **serve_kw)
    s_launches = read_counts(wrappers)
    check_counts("bpe serving", s_launches, expected_counts([lm_a], plan["steps"], len(plan["groups"])))
    check(s_texts == texts, "bpe: the serving decode's texts differ from the dense decode's")
    serve_beams = decoder.decode_beams_batch(logits, **serve_kw, **beams_kw)
    d_score = check_same_results("bpe serving vs dense", dense_beams, serve_beams, LM_SCORE_TOL)
    log(f"[bpe] serving decode_batch, chunks of {CHUNK}, collapse, groups {plan['groups']} with "
        f"{plan['group_steps']} virtual steps ({plan['frames_kept']} of {plan['frames_in']} frames kept): texts, "
        f"text_frames and states equal the dense path's, max lm_score diff {d_score:.3g}")

    piped = pipelined("bpe", decoder, [lm_a], logits, serve_kw, serve_beams, wrappers)

    # two members and the hotwords, dense
    multi = P.TorchBeamSearchDecoderCTC(alphabet, P.MultiLanguageModel(members))
    hot_kw = dict(dense_kw, hotwords=hot)
    reset_counts(wrappers)
    h_beams = multi.decode_beams_batch(logits, **hot_kw, **beams_kw)
    h_launches = read_counts(wrappers)
    check_counts("bpe hot2lm dense", h_launches, expected_counts(members, launched(steps), 1))
    h_wer = word_error_rate(corpus.references, top_texts(h_beams))
    log(f"[bpe] two members + {len(hot)} hotwords, dense: WER {h_wer:.4f}")

    # the first utterances on the CPU (dense: the serving texts equal the dense
    # ones on the card), member A alone, then the two members with the hotwords
    sub = [m[:CPU_FRAMES] for m in logits[:CPU_CHECK]]
    cpu_diff = {}
    for tag, kw, gpu_dec, lm, batch_texts in (
            ("dense", dense_kw, decoder, lm_a, texts),
            ("hot2lm dense", hot_kw, multi, P.MultiLanguageModel(members), top_texts(h_beams))):
        kw = dict(kw, batch_pad=1)
        whole = gpu_dec.decode_beams_batch(logits[:CPU_CHECK], **kw, **beams_kw)
        check(top_texts(whole) == batch_texts[:CPU_CHECK], f"bpe {tag}: batch-of-{N_UTTS} texts differ")
        gpu_beams = gpu_dec.decode_beams_batch(sub, **kw, **beams_kw)
        cpu_beams = P.TorchBeamSearchDecoderCTC(alphabet, lm, device="cpu").decode_beams_batch(sub, **kw, **beams_kw)
        cpu_diff[tag] = check_same_results(f"bpe {tag}: GPU vs CPU", cpu_beams, gpu_beams, LM_SCORE_TOL)
        log(f"[check] bpe {tag}: first {CPU_FRAMES} frames of the first {CPU_CHECK} utterances identical on the "
            f"CPU (max lm_score diff {cpu_diff[tag]:.3g})")
    del multi

    segments_case("bpe dense", decoder, [lm_a], logits, dict(dense_kw, **beams_kw), [steps], wrappers)
    bt_args = tail_case(torch, "bpe dense", decoder, logits, dict(dense_kw, **beams_kw))
    return decoder, logits, {"backtrace_args": bt_args["full"],
        "labels": labels, "lmax": lmax, "pieces": pieces, "frame_sec": BPE_FRAME_SEC,
        "frame_steps": steps, "launches": launches, "wer": wer,
        "wer_greedy": wer_greedy, "texts_with_unknown_piece": forced, "step_kernels": step_rec,
        "serving": dict(plan, launches=s_launches, max_lm_score_diff_vs_dense=d_score, pipelined_launches=piped),
        "hot2lm": {"launches": h_launches, "wer": h_wer},
        "cpu_checked": CPU_CHECK, "cpu_max_lm_score_diff": cpu_diff,
    }


def park(decoder) -> None:
    """Free ``decoder``'s device tables (its host tables stay), so later peaks count only their own."""
    decoder._tabs = None
    decoder._hot_cache.clear()
    decoder._empty_hot_tables = None
    decoder._graphs.clear()  # captured segments hold the tables they read


def unpark(decoder) -> None:
    """Upload ``decoder``'s tables to the card again (the host tables are built once)."""
    from pyctcdecode_torch.engine import build_table_args

    decoder._tabs = build_table_args(decoder._tokens, decoder._device_lm, decoder.device)


def chunked(mat) -> list:
    return [mat[i : i + STREAM_CHUNK] for i in range(0, mat.shape[0], STREAM_CHUNK)]


def run_stream(decoder, chunks, force_at=None, hot_calls=None, states=None, **start_kw):
    """One stream over ``chunks`` (``is_end`` on the last): its views.

    ``hot_calls``: the hotword list of each call (the state is made with
    hotwords enabled). ``states`` (a list) gets a copy of the carried state
    after each call.
    """
    state = decoder.get_starting_state(beam_width=BEAM, hotwords_enabled=hot_calls is not None, **start_kw)
    views = []
    for i, chunk in enumerate(chunks):
        kw = {} if hot_calls is None else dict(hotwords=hot_calls[i])
        views.append(decoder.partial_decode_beams(
            state, chunk, force_next_word=(i == force_at), is_end=(i == len(chunks) - 1), **kw))
        if states is not None:
            states.append({key: val.clone() for key, val in state.beam_state.items()})
    return views


def host_stream(host, chunks, force_at=None, hot_calls=None):
    """The host oracle's stream over ``chunks`` (``is_end`` on the last): its views."""
    from pyctcdecode_torch.constants import DEFAULT_HOTWORD_WEIGHT
    from pyctcdecode_torch.decoder import Beam
    from pyctcdecode_torch.models.hotwords import HotwordScorer

    beams, lm_cache, p_cache = host.get_starting_state()
    offset, views = 0, []
    for i, chunk in enumerate(chunks):
        scorer = None if hot_calls is None else HotwordScorer.build_scorer(hot_calls[i], DEFAULT_HOTWORD_WEIGHT)
        out = host.partial_decode_beams(chunk, lm_cache, p_cache, beams, offset, beam_width=BEAM,
                                        hotword_scorer=scorer, force_next_word=(i == force_at),
                                        is_end=(i == len(chunks) - 1))
        beams = [Beam.from_lm_beam(b) for b in out]
        offset += chunk.shape[0]
        views.append(out)
    return views


def record_stream_calls(torch, decoder, chunks, step: int) -> dict:
    """The arguments each kernel wrapper gets in a stream over ``chunks`` (the last one ends it).

    ``expand_merge_prune``, ``gather_rows`` and ``probe_rows`` at frame
    ``step``'s step; ``merge_prune`` at the finalize of the chunk that holds
    that frame, which must not be the last (so it does not commit: the merge
    key carries the partial, last-token and force lanes). A one-member
    decoder, its step's commit on the PyTorch composition
    (``commit_words_ref``) while it records: one ``gather_rows`` a step, one
    ``probe_rows`` a step and two a finalize.
    """
    from pyctcdecode_torch import engine
    from pyctcdecode_torch.models import device_tables

    chunk_of = step // STREAM_CHUNK
    check(chunk_of < len(chunks) - 1, "the recorded step lies in the stream's last chunk")
    check(len(decoder._lm_members) == 1 and decoder.language_model.score_boundary,
          "the recorded stream's decoder is not one member that scores </s>")
    want = {"expand_merge_prune": step, "gather_rows": step, "probe_rows": step + 2 * chunk_of,
            "merge_prune": chunk_of}
    sites = {"expand_merge_prune": engine, "merge_prune": engine, "gather_rows": device_tables,
             "probe_rows": device_tables}
    originals = {name: getattr(site, name) for name, site in sites.items()}
    seen = dict.fromkeys(sites, 0)
    calls = {}

    def keep(a):
        # a step's planes are copied; the LM tables (millions of words, never
        # written, and lists of them) are kept by reference
        if isinstance(a, dict):
            return {k: v.clone() for k, v in a.items()}
        if isinstance(a, torch.Tensor) and a.numel() < (1 << 20):
            return a.clone()
        return a

    def recorder(name):
        def call(*args, **kwargs):
            if seen[name] == want[name]:
                calls[name] = tuple(keep(a) for a in args)
            seen[name] += 1
            return originals[name](*args, **kwargs)
        return call

    for name, site in sites.items():
        setattr(site, name, recorder(name))
    commit = engine.commit_words
    engine.commit_words = engine.commit_words_ref  # the step's probes as one probe_rows call
    try:
        run_stream(decoder, chunks)
    finally:
        for name, site in sites.items():
            setattr(site, name, originals[name])
        engine.commit_words = commit
    torch.cuda.synchronize()
    check(set(calls) == set(sites), f"a stream of {len(chunks)} chunks did not reach every recorded call")
    return calls


def check_views(tag: str, want, got, tol: float, top_only: bool = False) -> float:
    """Two streams' views chunk by chunk: words, partial words and spans identical, scores within ``tol``."""
    check(len(want) == len(got), f"{tag}: {len(got)} views for {len(want)} chunks")
    worst = 0.0
    for i, (w, g) in enumerate(zip(want, got)):
        check(len(w) > 0 and (top_only or len(w) == len(g)), f"{tag}: chunk {i}: beam counts differ")
        for wb, gb in zip(w[:1] if top_only else w, g):
            check((wb.text, wb.partial_word) == (gb.text, gb.partial_word), f"{tag}: chunk {i}: words differ")
            check((wb.text_frames, wb.partial_frames) == (gb.text_frames, gb.partial_frames),
                  f"{tag}: chunk {i}: frame spans differ")
            d = max(abs(wb.lm_score - gb.lm_score), abs(wb.logit_score - gb.logit_score))
            worst = max(worst, d)
            check(d <= tol, f"{tag}: chunk {i}: scores differ by {d}")
    return worst


def check_stream_is_full_decode(tag: str, full, view) -> float:
    """The last (``is_end``) view of a stream against the full decode: same beams, lm_score within 1e-3."""
    check(len(full) == len(view) > 0, f"{tag}: {len(view)} beams for the full decode's {len(full)}")
    worst = 0.0
    for f, v in zip(full, view):
        check(f.text == v.text and [wf[1] for wf in f.text_frames] == v.text_frames,
              f"{tag}: the stream's beams differ from the full decode's")
        worst = max(worst, abs(f.lm_score - v.lm_score))
        check(worst <= LM_SCORE_TOL, f"{tag}: lm_score differs from the full decode's by {worst}")
    return worst


def check_states(tag: str, want, got) -> None:
    """Two streams' carried states after every chunk: every plane equal to the bit."""
    import torch

    check(len(want) == len(got), f"{tag}: {len(got)} states for {len(want)} chunks")
    for i, (w, g) in enumerate(zip(want, got)):
        check(set(w) == set(g), f"{tag}: chunk {i}: the state planes differ")
        for key in w:
            check(w[key].dtype == g[key].dtype and torch.equal(w[key], g[key]),
                  f"{tag}: chunk {i}: carried state plane {key} differs")


def stream_column(tag: str, dec, members, utts, wrappers: dict, hotwords=None) -> dict:
    """The streams of one column: ``dec`` replays graphs (``segment_frames`` 16) or runs eagerly (0).

    ``hotwords``: the hotword list every chunk passes (the states made with
    hotwords enabled), or None. The streams of ``utts``, each with its launch
    counts (``expected_counts`` of the launched steps: the chunks padded to
    whole segments under graphs, one finalize per chunk, no batch
    backtrace), its views and the carried state after every chunk.
    """
    seg = dec._segment_frames_effective()
    views, states, launches = [], [], None
    for u, mat in enumerate(utts):
        chunks = chunked(mat)
        reset_counts(wrappers)
        st: list = []
        views.append(run_stream(dec, chunks, hot_calls=None if hotwords is None else [hotwords] * len(chunks),
                                states=st))
        got = read_counts(wrappers)
        steps = sum(launched(c.shape[0], seg) for c in chunks)
        check_counts(f"stream {tag} utterance {u}", got, expected_counts(members, steps, len(chunks), stream=True))
        launches = got if launches is None else {k: launches[k] + got[k] for k in got}
        states.append(st)
    return {"segment_frames": seg, "launches": launches, "views": views, "states": states}


def interleaved(dec, mats) -> list:
    """Streams of ``mats`` on one decoder, chunk by chunk in turns: each stream's views."""
    lists = [chunked(m) for m in mats]
    states = [dec.get_starting_state(beam_width=BEAM) for _ in mats]
    views: list = [[] for _ in mats]
    for i in range(max(map(len, lists))):
        for j, chunks in enumerate(lists):
            if i < len(chunks):
                views[j].append(dec.partial_decode_beams(states[j], chunks[i], is_end=(i == len(chunks) - 1)))
    return views


def stream_phase(torch, P, merge, gather, decoders: dict, corpus, hot, bpe_logits) -> dict:
    """The ``stream`` path: ``get_starting_state`` / ``partial_decode_beams`` in 25-frame chunks.

    ``decoders``: the char decoder with member A (``"char"``), the hot2lm
    two-member decoder (``"hot2lm"``) and the bpe decoder (``"bpe"``), their
    device tables parked. Each path runs in two columns: through captured
    graphs (the CUDA default: each chunk's segments and its finalize
    replayed) and on a ``with_options(segment_frames=0)`` clone (the eager
    loop). Checks, all at beam 100 on the card: the graph stream's views
    and carried state equal the eager stream's to the bit at every chunk;
    each of the first ``STREAM_UTTS`` utterances' streams equals its full
    decode, with the launch counts of its (padded) steps and one finalize
    per chunk; two streams interleaved chunk by chunk on one decoder give
    each stream's views alone; the kernels on a stream's inputs against
    their plain versions (timed); the first utterance's stream with
    ``force_next_word`` at the middle chunk equals the host oracle's top
    view at every chunk (within 2e-3), and the eager stream's to the bit;
    the first ``STREAM_CPU_CHUNKS`` chunks of it on a ``device="cpu"``
    decoder give identical views; the hot2lm stream with the hotwords
    equals the full decode, and with the hotword list written anew from the
    middle chunk on (the same unigram set: the carried partial words walk
    the new trie) the host oracle's views; the bpe stream equals the full
    decode.
    """
    wrappers = counters(merge, gather)
    char = decoders["char"]
    unpark(char)
    lm_a = char.language_model
    eager = char.with_options(segment_frames=0)
    utts = corpus.logits[:STREAM_UTTS]
    rec: dict = {"chunk_frames": STREAM_CHUNK, "utterances": STREAM_UTTS}

    g = stream_column("graphs", char, [lm_a], utts, wrappers)
    e = stream_column("eager", eager, [lm_a], utts, wrappers)
    worst = 0.0
    for u, mat in enumerate(utts):
        check_views(f"stream utterance {u}: graphs vs eager", e["views"][u], g["views"][u], 0.0)
        check_states(f"stream utterance {u}: graphs vs eager", e["states"][u], g["states"][u])
        worst = max(worst, check_stream_is_full_decode(
            f"stream utterance {u}", char.decode_beams(mat, beam_width=BEAM), g["views"][u][-1]))
    # two streams in turns on one decoder: every state copied into the graphs' buffers and out again
    inter = interleaved(char, utts)
    for u in range(len(utts)):
        check_views(f"stream utterance {u}: interleaved vs alone", g["views"][u], inter[u], 0.0)
    log(f"[stream] graphs vs eager: every view and carried state plane equal to the bit at every chunk "
        f"(lm_score difference 0); every stream equals its full decode (max lm_score diff {worst:.3g}); "
        f"{len(utts)} streams interleaved chunk by chunk on one decoder give each stream's views alone")
    rec.update(launches=g["launches"], launches_eager=e["launches"], max_lm_score_diff_vs_full=worst)
    del g, e, inter

    # each kernel on the inputs the stream gives it (recorded on the eager loop, whose
    # wrappers are called per step): frame 60's step, and the finalize of its chunk
    # (not committing), held against the plain versions
    chunks = chunked(utts[0])
    calls = record_stream_calls(torch, eager, chunks[:4], step=60)
    kern = {}
    kern["expand_merge_prune"], _ = expand_case(
        torch, merge, f"expand_merge_prune stream step {list(calls['expand_merge_prune'][3].shape)}",
        calls["expand_merge_prune"])
    kern["merge_prune"], _ = merge_case(
        torch, merge, f"merge_prune stream finalize {list(calls['merge_prune'][0].shape)}, window off",
        calls["merge_prune"])
    step_calls = {"stream": (1, {"gather": calls["gather_rows"], "probe": calls["probe_rows"]})}
    kern["gather_rows"] = gather_phases(torch, gather, step_calls, synthetic=False)["stream step: trie rows"]
    kern["probe_rows"] = probe_phases(torch, gather, step_calls)["stream"]
    rec["kernels"] = kern
    del calls, step_calls

    # the host oracle, with a forced commit at the middle chunk; the eager stream beside it
    mid = len(chunks) // 2
    host = P.BeamSearchDecoderCTC(P.Alphabet.build_alphabet(LIBRI_LABELS), lm_a)
    h_views = host_stream(host, chunks, force_at=mid)
    st_g, st_e = [], []
    d_views = run_stream(char, chunks, force_at=mid, states=st_g)
    e_views = run_stream(eager, chunks, force_at=mid, states=st_e)
    check_views("stream forced: graphs vs eager", e_views, d_views, 0.0)
    check_states("stream forced: graphs vs eager", st_e, st_g)
    d_host = check_views("stream vs host oracle", h_views, d_views, HOST_TOL, top_only=True)
    log(f"[stream] utterance 0 with force_next_word at chunk {mid} of {len(chunks)}: graphs equal eager to the bit; "
        f"every chunk's top view equals the host oracle's (max score diff {d_host:.3g})")
    rec.update(max_score_diff_vs_host=d_host, forced_chunk=mid)
    del st_g, st_e

    # the first chunks of utterance 0 on the CPU (the plain versions)
    head = chunks[:STREAM_CPU_CHUNKS]
    cpu = P.TorchBeamSearchDecoderCTC(P.Alphabet.build_alphabet(LIBRI_LABELS), lm_a, device="cpu")
    d_cpu = check_views("stream GPU vs CPU", run_stream(cpu, head), run_stream(char, head), LM_SCORE_TOL)
    log(f"[check] stream: the first {len(head)} chunks of utterance 0 give identical views on the CPU (max score "
        f"diff {d_cpu:.3g})")
    rec["cpu_chunks"], rec["cpu_max_score_diff"] = len(head), d_cpu
    del cpu, eager
    park(char)

    # hot2lm: two members and the hotwords; then the hotword list written anew mid-stream
    multi = decoders["hot2lm"]
    unpark(multi)
    m_eager = multi.with_options(segment_frames=0)
    members = list(multi.language_model._language_models)
    rewritten = sorted({w for phrase in hot for w in phrase.split()}, reverse=True)
    hot_calls = [hot] * mid + [rewritten] * (len(chunks) - mid)
    h_rec = {}
    for tag, dec in (("graphs", multi), ("eager", m_eager)):
        col = stream_column(f"hot2lm {tag}", dec, members, utts[:1], wrappers, hotwords=hot)
        st: list = []
        col["r_views"] = run_stream(dec, chunks, hot_calls=hot_calls, states=st)
        col["r_states"] = st
        h_rec[tag] = col
    check_views("stream hot2lm: graphs vs eager", h_rec["eager"]["views"][0], h_rec["graphs"]["views"][0], 0.0)
    check_states("stream hot2lm: graphs vs eager", h_rec["eager"]["states"][0], h_rec["graphs"]["states"][0])
    check_views("stream hot2lm rewritten: graphs vs eager", h_rec["eager"]["r_views"], h_rec["graphs"]["r_views"], 0.0)
    check_states("stream hot2lm rewritten: graphs vs eager", h_rec["eager"]["r_states"], h_rec["graphs"]["r_states"])
    d_full = check_stream_is_full_decode("stream hot2lm", multi.decode_beams(utts[0], beam_width=BEAM, hotwords=hot),
                                         h_rec["graphs"]["views"][0][-1])
    h_views = host_stream(P.BeamSearchDecoderCTC(P.Alphabet.build_alphabet(LIBRI_LABELS),
                                                 P.MultiLanguageModel(members)), chunks, hot_calls=hot_calls)
    d_hhost = check_views("stream hot2lm vs host oracle", h_views, h_rec["graphs"]["r_views"], HOST_TOL, top_only=True)
    log(f"[stream] hot2lm, utterance 0, {len(hot)} hotwords: graphs equal eager to the bit (and with the list "
        f"rewritten); equals the full decode (max lm_score diff {d_full:.3g}); with the hotword list written anew "
        f"from chunk {mid} on ({len(rewritten)} words, the same unigram set: the same key) every chunk's top view "
        f"equals the host oracle's (max score diff {d_hhost:.3g})")
    rec["hot2lm"] = dict(launches=h_rec["graphs"]["launches"], max_lm_score_diff_vs_full=d_full,
                         max_score_diff_vs_host=d_hhost)
    del m_eager, h_rec
    park(multi)

    # bpe: the 128-piece vocabulary, 25 frames of 0.04 s a chunk
    bpe = decoders["bpe"]
    unpark(bpe)
    b_eager = bpe.with_options(segment_frames=0)
    mat = bpe_logits[0]
    b_rec = {tag: stream_column(f"bpe {tag}", dec, [bpe.language_model], [mat], wrappers)
             for tag, dec in (("graphs", bpe), ("eager", b_eager))}
    check_views("stream bpe: graphs vs eager", b_rec["eager"]["views"][0], b_rec["graphs"]["views"][0], 0.0)
    check_states("stream bpe: graphs vs eager", b_rec["eager"]["states"][0], b_rec["graphs"]["states"][0])
    d_bpe = check_stream_is_full_decode("stream bpe", bpe.decode_beams(mat, beam_width=BEAM),
                                        b_rec["graphs"]["views"][0][-1])
    log(f"[stream] bpe, utterance 0 ({mat.shape[0]} frames of {BPE_FRAME_SEC} s, {len(chunked(mat))} chunks, "
        f"V {BPE_V}): graphs equal eager to the bit; equals the full decode (max lm_score diff {d_bpe:.3g})")
    rec["bpe"] = dict(launches=b_rec["graphs"]["launches"], frames=int(mat.shape[0]), max_lm_score_diff_vs_full=d_bpe)
    del b_eager, b_rec
    park(bpe)
    return rec


def bucket_residents(bucket: np.ndarray) -> np.ndarray:
    """Each bucket row's 32 slots as (fp_lo, fp_hi, prob, backoff) rows, sorted by fingerprint: ``[rows, 32, 4]``."""
    from pyctcdecode_torch.models.device_tables import _BUCKET_SLOTS, _SUB_BUCKETS

    u = bucket.view(np.uint32).reshape(len(bucket), _SUB_BUCKETS, 4, _BUCKET_SLOTS)
    slots = u.transpose(0, 1, 3, 2).reshape(len(bucket), _SUB_BUCKETS * _BUCKET_SLOTS, 4)
    key = (slots[..., 0].astype(np.uint64) << np.uint64(32)) | slots[..., 1].astype(np.uint64)
    return np.take_along_axis(slots, np.argsort(key, axis=1, kind="stable")[..., None], axis=1)


def native_phase(torch, P, arpa: str, logits):
    """The ``native`` path: ``build_ctcdecoder`` over member A's ARPA read by the C++ engine.

    Builds the engine (``g++``), then ``build_ctcdecoder`` (``"auto"`` reads
    plain ARPA natively) and the same decoder over the same file read in
    Python. The device tables must equal the Python build's: unigrams, trie
    plane and seeds exactly; each order's bucket sizes and fingerprint seeds
    exactly, and every bucket row's residents (the engine hands entries over
    in another order, so slots within a row may differ: counted and logged).
    The first ``NATIVE_UTTS`` utterances decode equal on both (texts,
    frames, LM states, lm_score difference 0). Returns the record, the
    native decoder (the main paths' decoder) and the Python-read
    LanguageModel (its host tables serve the probe's seeded queries and the
    KenLM writers).
    """
    from pyctcdecode_torch.csrc.native import load_native
    from pyctcdecode_torch.models.native import NativeNGramModel
    from pyctcdecode_torch.models.ngram import load_unigram_set_from_arpa, open_ngram_file

    check(load_native() is not None, "the native n-gram engine did not build")
    decoder = P.build_ctcdecoder(LIBRI_LABELS, arpa)
    check(isinstance(decoder.language_model.ngram_model, NativeNGramModel),
          "build_ctcdecoder did not read the ARPA with the native engine")
    lm_py = P.LanguageModel(open_ngram_file(arpa, backend="python"), load_unigram_set_from_arpa(arpa))
    py_dec = P.TorchBeamSearchDecoderCTC(P.Alphabet.build_alphabet(LIBRI_LABELS), lm_py)
    check(lm_py.unigram_set == decoder.language_model.unigram_set, "the two readers' unigram sets differ")
    nat, py = decoder._device_lm[0], py_dec._device_lm[0]
    for attr in ("uni", "start_ctx", "start_ctx_backoffs", "seed_node"):
        check(np.array_equal(getattr(nat, attr), getattr(py, attr)), f"native tables: {attr} differs")
    check(np.array_equal(nat.trie_plane(), py.trie_plane()), "native tables: the trie plane differs")
    rows_moved = []
    for n, (a, b) in enumerate(zip(nat.fp_tables, py.fp_tables), start=2):
        check((a.size, a.seed_lo, a.seed_hi, a.count) == (b.size, b.seed_lo, b.seed_hi, b.count),
              f"native tables: order {n}'s size, seeds or count differ")
        check(np.array_equal(bucket_residents(a.bucket), bucket_residents(b.bucket)),
              f"native tables: order {n}'s buckets hold other residents")
        rows_moved.append(int((a.bucket != b.bucket).any(axis=1).sum()))
    kw = dict(beam_width=BEAM, prune_history=True, top_n=1)
    want = py_dec.decode_beams_batch(logits[:NATIVE_UTTS], **kw)
    got = decoder.decode_beams_batch(logits[:NATIVE_UTTS], **kw)
    d = check_same_results("native vs python reader", want, got, 0.0)
    del py_dec
    torch.cuda.empty_cache()
    log(f"[native] build_ctcdecoder over the ARPA read natively and over the same file read in Python: device "
        f"tables equal but for the slot order within {rows_moved} bucket rows of {[t.size for t in nat.fp_tables]} "
        f"(the same residents in every row); the first {NATIVE_UTTS} utterances decode equal (texts, frames, LM "
        f"states, lm_score diff {d:.3g})")
    rec = {"bucket_rows_slot_order_differs": rows_moved, "bucket_rows": [t.size for t in nat.fp_tables],
           "utterances_checked": NATIVE_UTTS, "max_lm_score_diff": d}
    return rec, decoder, lm_py


def sharded_phase(torch, merge, gather, decoder, corpus, dense_beams, serve_beams) -> dict:
    """The ``sharded`` path: ``ShardedCTCDecoder(shard_lm=True)`` over a world-size-1 NCCL group.

    The group comes up through ``parallel.launch`` (127.0.0.1, a free port);
    member A's bucket planes are row-sharded over it, so every probe of a
    step and of a finalize is one collective round trip (``all_gather`` of
    the queries, one ``probe_rows`` launch on the local window,
    ``all_reduce`` of the answers). Two columns: graphs (the default: the
    main decoder's segments of 16 steps and its finalize, each a captured
    CUDA graph with the collectives inside, in the main decoder's graph
    cache) and eager (a wrapped decoder made with
    ``with_options(segment_frames=0)``). ``decode_beams_batch`` dense and with
    the serving options (chunks, blank collapse), both with
    ``collect_stats``, on each column: texts, frames and LM states equal
    the dense and serving results from earlier in the run (lm_score
    difference 0), the counters equal the unsharded decoder's for the same
    call, the launches ``expected_counts`` (graphs: padded to whole
    segments); under graphs the first call captures one new key and a warm
    call captures nothing. The sharded keys are dropped before the group
    goes (their graphs hold its communicator's collectives).
    """
    import socket

    import torch.distributed as dist

    from pyctcdecode_torch.constants import DEFAULT_MIN_TOKEN_LOGP
    from pyctcdecode_torch.parallel import ShardedCTCDecoder, make_data_mesh
    from pyctcdecode_torch.parallel.launch import initialize_from_env
    from pyctcdecode_torch.utils.logits import normalize_collapse_batch, token_timeline_batch

    wrappers = counters(merge, gather)
    lm = decoder.language_model
    logits = corpus.logits
    t_max = max(m.shape[0] for m in logits)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    check(initialize_from_env(coordinator=f"127.0.0.1:{port}", num_processes=1, process_id=0),
          "the process group did not come up")
    rec: dict = {}
    sharded = None
    try:
        mesh = make_data_mesh()
        check(dist.get_backend() == "nccl" and mesh.size() == 1, "not a world-size-1 NCCL mesh")
        sharded = ShardedCTCDecoder(decoder, mesh=mesh, shard_lm=True)
        eager = ShardedCTCDecoder(decoder.with_options(segment_frames=0), mesh=mesh, shard_lm=True)
        tabs = sharded._tabs
        fp = tabs["lms"][0]["fp"]
        check(all(t["row0"] == 0 and t["bucket"].shape[0] == t["size"] for t in fp)
              and "shard" in tabs["lms"][0], "the sharded tables are not one whole window")
        eager.decode_beams_batch([logits[0][:8]], beam_width=BEAM)  # NCCL's communicator, outside any capture
        beams_kw = dict(beam_width=BEAM, prune_history=True, top_n=1, collect_stats=True)
        serve_kw = dict(token_chunking=True, blank_collapse=True)
        mats, _, _ = normalize_collapse_batch(logits, LIBRI_LABELS.index(""), DEFAULT_MIN_TOKEN_LOGP)
        v_steps = int(max(token_timeline_batch(mats, DEFAULT_MIN_TOKEN_LOGP, CHUNK)[1]))

        def sharded_keys() -> list:
            return [key for key in decoder._graphs if key[3] == id(tabs)]

        def run(tag: str, column: str, dec, kw: dict, steps: int, want_beams, want_stats) -> dict:
            """One sharded decode of the corpus, checked: its launch counts."""
            reset_counts(wrappers)
            got, stats = dec.decode_beams_batch(logits, **beams_kw, **kw)
            launches = read_counts(wrappers)
            check_counts(f"sharded {tag} {column}", launches, expected_counts([lm], steps, 1, sharded=True))
            check_same_results(f"sharded {tag} {column} vs {tag}", want_beams, got, 0.0)
            check(stats == want_stats, f"sharded {tag} {column}: the counters differ from the unsharded decoder's")
            return launches

        for tag, kw, steps, want_beams in (("dense", {}, t_max, dense_beams), ("serving", serve_kw, v_steps, serve_beams)):
            _, want_stats = decoder.decode_beams_batch(logits, **beams_kw, **kw)
            held = set(sharded_keys())
            launches = run(tag, "graphs", sharded, kw, launched(steps), want_beams, want_stats)
            new = [key for key in sharded_keys() if key not in held]
            check(len(new) == 1, f"sharded {tag}: {len(new)} new graph keys, expected 1")
            seg_graph = decoder._graphs[new[0]]
            check(seg_graph.graph is not None and all(f.graph is not None for f in seg_graph.finals.values()),
                  f"sharded {tag}: the decode did not run through captured graphs")
            held_graphs = (seg_graph.graph, [f.graph for f in seg_graph.finals.values()])
            run(tag, "graphs warm", sharded, kw, launched(steps), want_beams, want_stats)
            check((seg_graph.graph, [f.graph for f in seg_graph.finals.values()]) == held_graphs
                  and len(sharded_keys()) == len(held) + 1, f"sharded {tag}: the warm call captured again")
            eager_launches = run(tag, "eager", eager, kw, steps, want_beams, want_stats)
            log(f"[sharded] {tag} decode_beams_batch {N_UTTS} x beam {BEAM}, shard_lm on, collect_stats, graphs "
                f"(first and warm) and eager: equal to the {tag} results (lm_score difference 0), counters equal "
                f"the unsharded decoder's")
            rec[tag] = dict(launches=launches, eager_launches=eager_launches)
    finally:
        if sharded is not None:  # the sharded keys' graphs replay the group's collectives: they go first
            for key in [key for key in decoder._graphs if key[3] == id(sharded._tabs)]:
                del decoder._graphs[key]
            torch.cuda.synchronize()
        del sharded
        dist.destroy_process_group()
    return rec


def add_counts(*counts: dict) -> dict:
    return {name: sum(c[name] for c in counts) for name in counts[0]}


def evaluation_phase(torch, P, merge, gather, decoder, corpus, texts: list, wer_greedy: float) -> dict:
    """The corpus evaluation harness on the card: ``evaluate_corpus``, ``compare_engines``, ``normalize_to_logp_torch``.

    ``evaluate_corpus`` decodes the dense configuration (the corpus, beam
    100, member A) on the main decoder after its warm-up batch (utterance
    0): WER beside the greedy WER; its hypotheses must be the dense phase's
    ``texts``, its launches those of the warm-up and the corpus decode.
    ``compare_engines`` holds the host oracle over the same LM against the
    card on the first ``EVAL_HOST_UTTS`` utterances: both WERs, top-1
    agreement (every utterance must agree, the JAX package's 0.99 bound at
    this count); the card's hypotheses must be the dense phase's.
    ``normalize_to_logp_torch`` of utterance 0's logits and of its
    probabilities on the card must be within ``NORM_TOL`` of the same call
    on the CPU.
    """
    from pyctcdecode_torch.evaluation import Corpus, compare_engines, evaluate_corpus
    from pyctcdecode_torch.utils import normalize_to_logp_torch

    wrappers = counters(merge, gather)
    lm = decoder.language_model
    logits = corpus.logits
    warm_steps = launched(logits[0].shape[0])
    reset_counts(wrappers)
    report = evaluate_corpus(decoder, corpus, beam_width=BEAM, max_tokens_per_frame=None)
    launches = read_counts(wrappers)
    check_counts("evaluation evaluate_corpus", launches,
                 add_counts(expected_counts([lm], warm_steps, 1),
                            expected_counts([lm], launched(max(m.shape[0] for m in logits)), 1)))
    check(report["hypotheses"] == texts, "evaluate_corpus: the hypotheses differ from the dense decode's")
    check(report["n_utterances"] == N_UTTS and report["beam_width"] == BEAM, "evaluate_corpus: a bad report")
    log(f"[evaluation] evaluate_corpus on the card, {N_UTTS} utterances x beam {BEAM}, member A: WER "
        f"{report['wer']:.4f} (greedy {wer_greedy:.4f}); hypotheses equal the dense decode's")

    first = Corpus(corpus.references[:EVAL_HOST_UTTS], logits[:EVAL_HOST_UTTS], corpus.labels)
    host = P.BeamSearchDecoderCTC(P.Alphabet.build_alphabet(LIBRI_LABELS), lm)
    reset_counts(wrappers)
    cmp = compare_engines(host, decoder, first, beam_width=BEAM, max_tokens_per_frame=None)
    check_counts("evaluation compare_engines", read_counts(wrappers),
                 add_counts(expected_counts([lm], warm_steps, 1),
                            expected_counts([lm], launched(max(m.shape[0] for m in first.logits)), 1)))
    check(cmp["device_hypotheses"] == texts[:EVAL_HOST_UTTS],
          "compare_engines: the card's hypotheses differ from the dense decode's")
    check(cmp["top1_agreement"] == 1.0, f"compare_engines: top-1 agreement {cmp['top1_agreement']}")
    log(f"[evaluation] compare_engines, the first {EVAL_HOST_UTTS} utterances x beam {BEAM}: host oracle WER "
        f"{cmp['host']['wer']:.4f}, card WER {cmp['device']['wer']:.4f}, top-1 agreement {cmp['top1_agreement']}")

    norm = {}
    x = logits[0]
    probs = np.exp(x - x.max(-1, keepdims=True))
    probs = (probs / probs.sum(-1, keepdims=True)).astype(np.float32)
    for kind, mat in (("logits", x), ("probs", probs)):
        dev = normalize_to_logp_torch(torch.as_tensor(mat, device="cuda"))
        cpu = normalize_to_logp_torch(torch.as_tensor(mat))
        err = float((dev.cpu() - cpu).abs().max())
        check(dev.is_cuda and torch.allclose(dev.cpu(), cpu, rtol=NORM_TOL, atol=NORM_TOL),
              f"normalize_to_logp_torch on {kind}: the card's result is {err} off the CPU's")
        norm[kind] = err
    log(f"[evaluation] normalize_to_logp_torch on utterance 0's logits and probabilities {list(x.shape)}: the card "
        f"within {NORM_TOL} of the CPU (max abs diff {norm['logits']:.3g}, {norm['probs']:.3g})")
    return dict(wer=report["wer"], wer_greedy=wer_greedy, launches=launches, normalize_max_abs_diff=norm)


def window_phase(torch, gather, decoder, probe_call, card: str) -> dict:
    """``probe_rows`` on row windows: member A's two bucket planes cut into 2 and 4 row shards.

    Each window (a process's block of a plane row-sharded over 2 or 4
    processes) is probed with a real dense step's queries (``probe_call``),
    held against its plain version, and the windows' answers summed must be
    bit-equal to the whole probe; each window's launch is timed warm and
    with the L2 cache flushed beside the unwindowed one, with its bound.
    Runs right after the unwindowed probe's timing (late in a run the
    profiler's traces of small calls go incomplete).
    """
    from pyctcdecode_torch.models.device_tables import shard_bucket_plane, shard_rows

    full, ctx_len, tables, slots, sub_width = probe_call
    whole = gather.probe_rows(full, ctx_len, tables, slots, sub_width)
    flush = make_flush(torch, full.device)
    w_ms, _ = time_call(torch, lambda: gather.probe_rows(full, ctx_len, tables, slots, sub_width), WINDOW_REPS)
    w_cold, _ = time_call(torch, lambda: gather.probe_rows(full, ctx_len, tables, slots, sub_width), WINDOW_REPS,
                          flush=flush)
    q = ctx_len.numel()
    ops = sum(3.0 * 3 * (t + 2) for t in range(len(tables))) + 40.0 * len(tables)
    windows = {"whole": dict(ms=w_ms, cold_ms=w_cold)}
    host_planes = [t.bucket for t in decoder._device_lm[0].fp_tables]
    for n_shards in (2, 4):
        summed = None
        per = []
        for r in range(n_shards):
            tabs_r = [dict(tab, bucket=torch.as_tensor(shard_bucket_plane(plane, n_shards)[r]).to(full.device),
                           row0=r * shard_rows(tab["size"], n_shards))
                      for tab, plane in zip(tables, host_planes)]
            got = gather.probe_rows(full, ctx_len, tabs_r, slots, sub_width)
            want = gather.probe_rows_ref(full, ctx_len, tabs_r, slots, sub_width)
            check(all(torch.equal(g, w) for g, w in zip(got, want)),
                  f"probe_rows window {r} of {n_shards}: differs from the plain version")
            part = (got[0].to(torch.int32), got[1], got[2])
            summed = part if summed is None else tuple(a + b for a, b in zip(summed, part))
            ms, _ = time_call(torch, lambda: gather.probe_rows(full, ctx_len, tabs_r, slots, sub_width), WINDOW_REPS)
            cold, _ = time_call(torch, lambda: gather.probe_rows(full, ctx_len, tabs_r, slots, sub_width),
                                WINDOW_REPS, flush=flush)
            moved = nbytes([full, ctx_len]) + nbytes(got)
            owned = 0
            for t, tab in enumerate(tabs_r):
                local = gather.query_hashes(tab, full[..., len(tables) - 1 - t:])[0] % tab["size"] - tab["row0"]
                mine = local[(local >= 0) & (local < tab["bucket"].shape[0])]
                moved += int(mine.unique().numel()) * tab["bucket"].shape[1] * tab["bucket"].element_size()
                owned += int(mine.numel())
            b_ms, b_by = bound_ms(moved, ops * q)
            per.append(dict(ms=ms, cold_ms=cold, bound_ms=b_ms, bound_by=b_by, owned_queries=owned,
                            rows=[int(t["bucket"].shape[0]) for t in tabs_r]))
            del tabs_r
        check(torch.equal(summed[0] > 0, whole[0]) and int(summed[0].max()) <= 1
              and torch.equal(summed[1], whole[1]) and torch.equal(summed[2], whole[2]),
              f"probe_rows: the {n_shards} windows' answers do not sum to the whole probe's")
        windows[str(n_shards)] = per
        log(f"[windows] probe_rows over {n_shards} row windows of member A's planes, dense step queries "
            f"{list(full.shape)}: each equal to its plain version, summed bit-equal to the whole probe; window ms "
            f"{[round(w['ms'], 5) for w in per]}, L2 flushed {[round(w['cold_ms'], 5) for w in per]}, bounds "
            f"{[round(w['bound_ms'], 6) for w in per]} ({per[0]['bound_by']}); the whole table {w_ms:.5f} ms, "
            f"flushed {w_cold:.5f} ms [{card}]")
    return windows


def kenlm_build_phase(torch, P, gather, lm_a, dense_call, head) -> dict:
    """Member A as a KenLM PROBING binary, a decoder over it, and ``probe_rows`` in its KenLM mode.

    Runs right after the FNV probe's timing, on the same recorded dense step:
    the binary is written with the port's writer and ``build_ctcdecoder``
    reads it; the new decoder's own step 60 must issue the ARPA decoder's
    queries (the same word ids, the same beams), and ``probe_rows`` on them
    with the KenLM-keyed tables is held bit-exact against its plain version
    and timed beside the FNV probe of that step, also on seeded queries that
    hit every order. The decoder's device tables are parked for the
    ``kenlm`` phase.
    """
    from pyctcdecode_torch.csrc.build import BUILD_DIR
    from pyctcdecode_torch.models.kenlm_bin import KenLMBinaryModel, write_kenlm_binary

    bin_path = os.path.join(str(BUILD_DIR), "parity_3gram.bin")
    write_kenlm_binary(lm_a.ngram_model.tables, bin_path)
    built = P.build_ctcdecoder(LIBRI_LABELS, bin_path)
    lm_k = built.language_model
    modes = [t["hash_mode"] for t in built._tabs["lms"][0]["fp"]]
    check(isinstance(lm_k.ngram_model, KenLMBinaryModel) and modes == ["kenlm64", "kenlm64"],
          f"build_ctcdecoder did not read the binary into KenLM-keyed tables ({modes})")
    check(lm_k.ngram_model.tables.vocab == lm_a.ngram_model.tables.vocab, "the binary's word ids differ from the ARPA's")
    log(f"[kenlm] member A as a KenLM PROBING binary ({os.path.getsize(bin_path) / 1e6:.1f} MB), "
        f"build_ctcdecoder over it")
    call = record_step_reads(torch, built, head, step=60)["probe"]
    check(torch.equal(call[0], dense_call[0]) and torch.equal(call[1], dense_call[1]),
          "the KenLM decoder's step 60 queries differ from the ARPA decoder's")
    probe = probe_phases(torch, gather, {"kenlm dense": (N_UTTS, {"probe": call})}, lm_a.ngram_model.tables.ngrams)
    park(built)
    return {"decoder": built, "probe": probe, "arpa_vocab": lm_a.ngram_model.tables.vocab}


def kenlm_phase(torch, P, merge, gather, early: dict, arpa_dec, lm_b, corpus, dense_beams, serve_beams) -> dict:
    """The ``kenlm`` path: decoders saved and loaded as directories, over KenLM binaries.

    ``early``: :func:`kenlm_build_phase`'s record, with the decoder built
    over member A's PROBING binary. That decoder is saved with
    ``save_to_dir`` and loaded back with ``TorchBeamSearchDecoderCTC.load_from_dir``.
    The 32 utterances decode dense and serving: texts, frames and LM
    states (as words) equal the ARPA decoder's, scores within 1e-4, launch
    counts as the code implies (the binary keeps the ARPA's word ids, so
    the LM states compare as they are); the loaded decoder's ``probe_rows`` on a
    real dense step is held bit-exact against its plain version. Member B
    (the half-size 3-gram) is written as QUANT_TRIE (8 + 8 bits), saved and
    loaded the same way, and its first 2 utterances decode on the card as
    the port's host oracle loaded from the same directory does (top texts
    equal, scores within 2e-3; quantized scores differ from the ARPA's by
    design).
    """
    import shutil

    from pyctcdecode_torch.constants import DEFAULT_MIN_TOKEN_LOGP
    from pyctcdecode_torch.csrc.build import BUILD_DIR
    from pyctcdecode_torch.models.kenlm_bin import KenLMBinaryModel
    from pyctcdecode_torch.models.kenlm_trie import write_kenlm_trie

    wrappers = counters(merge, gather)
    lm_a = arpa_dec.language_model
    arpa_vocab = early["arpa_vocab"]
    logits = corpus.logits
    t_max = max(m.shape[0] for m in logits)
    build = str(BUILD_DIR)
    rec: dict = {"probe": early["probe"]}

    # the decoder over member A's PROBING binary: save_to_dir; load_from_dir
    save_dir = os.path.join(build, "kenlm_decoder")
    shutil.rmtree(save_dir, ignore_errors=True)
    os.makedirs(save_dir)
    early["decoder"].save_to_dir(save_dir)
    kdec = P.TorchBeamSearchDecoderCTC.load_from_dir(save_dir)
    lm_k = kdec.language_model
    k_vocab = lm_k.ngram_model.tables.vocab
    modes = [t["hash_mode"] for t in kdec._tabs["lms"][0]["fp"]]
    check(kdec.device.type == "cuda" and modes == ["kenlm64", "kenlm64"], f"the loaded decoder: {kdec.device}, {modes}")
    check(isinstance(lm_k.ngram_model, KenLMBinaryModel) and lm_k.order == 3, "load_from_dir did not read the binary")
    check(lm_k.unigram_set == {w for w in lm_a.unigram_set if not (w.startswith("<") and w.endswith(">"))},
          "the binary's unigrams differ from the ARPA's")
    check(k_vocab == arpa_vocab, "the binary's word ids differ from the ARPA's")
    sizes = [t["size"] for t in kdec._tabs["lms"][0]["fp"]]
    log(f"[kenlm] save_to_dir {sorted(os.listdir(save_dir))} + "
        f"{sorted(os.listdir(os.path.join(save_dir, 'language_model')))}; load_from_dir to a decoder on the card; "
        f"bucket rows per order {sizes}")
    rec["bucket_rows"] = sizes

    # the loaded decoder's probe on a real dense step, bit-exact (timed in kenlm_build_phase)
    full, ctx_len, k_tabs, slots, sub_width = record_step_reads(torch, kdec, [m[:61] for m in logits], step=60)["probe"]
    got = gather.probe_rows(full, ctx_len, k_tabs, slots, sub_width)
    want = gather.probe_rows_ref(full, ctx_len, k_tabs, slots, sub_width)
    check(all(torch.equal(g, w) for g, w in zip(got, want)), "the loaded decoder's probe_rows differs from its plain version")
    log(f"[kenlm] probe_rows of the loaded decoder on its dense step 60 {list(full.shape)}: equal to the plain version")
    del full, ctx_len, k_tabs, got, want

    # the 32 utterances dense and serving, against the ARPA decoder's
    dense_kw = dict(beam_width=BEAM, max_tokens_per_frame=None)
    beams_kw = dict(prune_history=True, top_n=1)
    reset_counts(wrappers)
    k_dense = kdec.decode_beams_batch(logits, **dense_kw, **beams_kw)
    launches = read_counts(wrappers)
    check_counts("kenlm dense", launches, expected_counts([lm_k], launched(t_max), 1))
    # the binary keeps the ARPA's word ids (checked above), so the LM states compare as they are
    d_dense = check_same_results("kenlm dense vs ARPA dense", dense_beams, k_dense, KENLM_TOL)
    log(f"[kenlm] dense decode_beams_batch {N_UTTS} x beam {BEAM}, K {K_TOKENS}, from the loaded directory: texts, "
        f"text_frames and LM states equal the ARPA decoder's, max lm_score diff {d_dense:.3g}")
    blank_id = LIBRI_LABELS.index("")
    plan = serving_plan(kdec, logits, blank_id, DEFAULT_MIN_TOKEN_LOGP)
    serve_kw = dict(beam_width=BEAM, **SERVING)
    reset_counts(wrappers)
    k_serve = kdec.decode_beams_batch(logits, **serve_kw, **beams_kw)
    s_launches = read_counts(wrappers)
    check_counts("kenlm serving", s_launches, expected_counts([lm_k], plan["steps"], len(plan["groups"])))
    d_serve = check_same_results("kenlm serving vs ARPA serving", serve_beams, k_serve, KENLM_TOL)
    log(f"[kenlm] serving decode_beams_batch (chunks of {CHUNK}, collapse, {len(plan['groups'])} groups): equal to "
        f"the ARPA decoder's serving results, max lm_score diff {d_serve:.3g}")
    rec.update(launches=launches, max_lm_score_diff_vs_arpa=d_dense,
               serving=dict(launches=s_launches, steps=plan["steps"], max_lm_score_diff_vs_arpa=d_serve))
    park(kdec)

    # member B as QUANT_TRIE, through a saved directory, on the card and on the host oracle
    q_path = os.path.join(build, "parity_3gram_half.binary")
    write_kenlm_trie(lm_b.ngram_model.tables, q_path, quant_bits=QUANT_BITS)
    host_built = P.build_ctcdecoder(LIBRI_LABELS, q_path, engine="host", alpha=lm_b.alpha, beta=lm_b.beta,
                                    unk_score_offset=lm_b.unk_score_offset, lm_score_boundary=lm_b.score_boundary)
    q_dir = os.path.join(build, "kenlm_decoder_quant")
    shutil.rmtree(q_dir, ignore_errors=True)
    os.makedirs(q_dir)
    host_built.save_to_dir(q_dir)
    host_built.cleanup()
    qdec = P.TorchBeamSearchDecoderCTC.load_from_dir(q_dir)
    qhost = P.BeamSearchDecoderCTC.load_from_dir(q_dir)
    lm_q = qdec.language_model
    check(lm_q.serializable_attrs == lm_b.serializable_attrs, "member B's fusion settings did not survive the directory")
    sub = logits[:QUANT_UTTS]
    reset_counts(wrappers)
    q_beams = qdec.decode_beams_batch(sub, beam_width=BEAM, prune_history=False)
    q_launches = read_counts(wrappers)
    check_counts("kenlm quant_trie", q_launches, expected_counts([lm_q], launched(max(m.shape[0] for m in sub)), 1))
    h_beams = [qhost.decode_beams(m, beam_width=BEAM, prune_history=False) for m in sub]
    qhost.cleanup()
    d_host = 0.0
    for i, (h, q) in enumerate(zip(h_beams, q_beams)):
        check(h[0].text == q[0].text, f"kenlm quant_trie: utterance {i}: top text differs from the host oracle's")
        d = max(abs(h[0].lm_score - q[0].lm_score), abs(h[0].logit_score - q[0].logit_score))
        check(d <= HOST_TOL, f"kenlm quant_trie: utterance {i}: scores differ from the host oracle's by {d}")
        d_host = max(d_host, d)
    log(f"[kenlm] member B as QUANT_TRIE ({QUANT_BITS[0]} prob + {QUANT_BITS[1]} backoff bits, "
        f"{os.path.getsize(q_path) / 1e6:.1f} MB) through load_from_dir to the card; {QUANT_UTTS} utterances: top "
        f"texts equal the host oracle's from the same directory (max score diff {d_host:.3g})")
    rec["quant_trie"] = dict(launches=q_launches, max_score_diff_vs_host=d_host, bits=list(QUANT_BITS))
    park(qdec)
    return rec


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=None, help="directory for the run's JSON record")
    args = parser.parse_args()
    t_start = time.perf_counter()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    import pyctcdecode_torch as P
    from pyctcdecode_torch.constants import DEFAULT_MIN_TOKEN_LOGP
    from pyctcdecode_torch.csrc.build import BUILD_DIR, build
    from pyctcdecode_torch.evaluation import DEV_OTHER_DIFFICULTY, TRANSCRIPT, synthesize_corpus
    from pyctcdecode_torch.ops import gather, merge
    from pyctcdecode_torch.utils.metrics import word_error_rate

    smi = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    card = f"{name}, power limit {smi.split(',')[-1].strip()}"
    log(f"[device] nvidia-smi: {smi}")
    log(f"[device] torch.cuda.get_device_name(0): {name}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    libs = build(verbose=True)
    log(f"[build] {', '.join(str(p.name) for p in libs.values())}")

    rec = kernel_phases(torch, merge)

    # ---- the decoder and the utterances of both paths
    arpa, vocab = parity_lm(str(BUILD_DIR))
    rng = np.random.RandomState(11)
    corpus_vocab = [vocab[i] for i in rng.randint(0, len(vocab), 6000)] + TRANSCRIPT.split()
    corpus = synthesize_corpus(LIBRI_LABELS, corpus_vocab, n_utterances=N_UTTS, seed=3,
                               **DEV_OTHER_DIFFICULTY)
    logits = corpus.logits
    # ---- the native path: build_ctcdecoder reads the ARPA with the C++ engine; the Python read beside it
    native_rec, decoder, lm_py = native_phase(torch, P, arpa, logits)
    lm = decoder.language_model
    check(decoder.device.type == "cuda", "decoder is not on CUDA")
    check(lm.order == 3, "the parity LM is not a 3-gram")
    t_max = max(m.shape[0] for m in logits)
    log(f"[main] corpus: {N_UTTS} utterances, {corpus.audio_seconds:.2f} audio-s, frames "
        f"{min(m.shape[0] for m in logits)}..{t_max}")

    # ---- gather kernel, also on the tables and indices of a real step of
    # each path (these short decodes are the first use of the libraries as well)
    blank_id = LIBRI_LABELS.index("")
    head = [m[:61] for m in logits]
    step_calls = {"dense": (N_UTTS, record_step_reads(torch, decoder, head, step=60))}
    head_plan = serving_plan(decoder, head, blank_id, DEFAULT_MIN_TOKEN_LOGP)
    check(head_plan["groups"][0] == GROUP_ROWS, f"the first length group has not {GROUP_ROWS} rows")
    step_calls["serving"] = (GROUP_ROWS, record_step_reads(
        torch, decoder, head, step=head_plan["group_steps"][0] // 2, **SERVING))
    log(f"[main] warm-up decodes of 61 frames (dense, and serving: groups with {head_plan['group_steps']} "
        f"virtual steps), recording one step's row reads of each")
    replay_cases = {"dense": record_replay(torch, decoder, head, 60, prune_history=False),
                    "n=1": record_replay(torch, decoder, head[:1], 60, prune_history=False, batch_pad=1)}
    commit_cases = {"dense": record_commit(torch, decoder, head, 60),
                    "dense, stats": record_commit(torch, decoder, head, 60, collect_stats=True),
                    "n=1": record_commit(torch, decoder, head[:1], 60, batch_pad=1)}
    walk_cases = {"char dense": record_walk_batch(torch, decoder, head, 60),
                  "stream n=1": record_walk_stream(torch, decoder, logits[0], 60)}
    # the w2v2 labels over the same LM: the walk's four levels (</s>) on the char path
    w2v2_dec = P.TorchBeamSearchDecoderCTC(P.Alphabet.build_alphabet(W2V2_LABELS), decoder.language_model)
    walk_cases["w2v2 dense"] = record_walk_batch(torch, w2v2_dec, w2v2_logits(head), 60)
    check(int(w2v2_dec._tabs["tok"]["raw_chars"].shape[1]) == 4, "the w2v2 labels do not walk four levels")
    del w2v2_dec
    gather_rec = gather_phases(torch, gather, step_calls)
    probe_rec = probe_phases(torch, gather, step_calls, lm_py.ngram_model.tables.ngrams)
    # probe_rows on row windows of the same tables (the sharded path's), on the same step's queries
    windows = window_phase(torch, gather, decoder, step_calls["dense"][1]["probe"], card)
    # probe_rows' KenLM mode on the same step's queries (member A as a KenLM binary)
    kenlm_early = kenlm_build_phase(torch, P, gather, lm_py, step_calls["dense"][1]["probe"], head)
    del step_calls

    # ---- dense path
    wrappers = counters(merge, gather)
    dense_kw = dict(beam_width=BEAM, max_tokens_per_frame=None)
    beams_kw = dict(prune_history=True, top_n=1)  # what decode_batch asks of decode_beams_batch
    reset_counts(wrappers)
    texts = decoder.decode_batch(logits, **dense_kw)
    launches = read_counts(wrappers)
    check_counts("dense", launches, expected_counts([lm], launched(t_max), 1))
    check(all(isinstance(t, str) for t in texts) and len(texts) == N_UTTS, "bad decode_batch output")
    dense_beams = decoder.decode_beams_batch(logits, **dense_kw, **beams_kw)
    check(top_texts(dense_beams) == texts, "repeated dense decode gave other texts")
    wer = word_error_rate(corpus.references, texts)
    greedy = []
    for m in logits:
        ids = m.argmax(axis=1)
        keep = np.concatenate([[True], ids[1:] != ids[:-1]])
        greedy.append(" ".join("".join(LIBRI_LABELS[i] for i in ids[keep]).split()))
    wer_greedy = word_error_rate(corpus.references, greedy)
    log(f"[dense] decode_batch {N_UTTS} x beam {BEAM}, K {K_TOKENS}, {t_max} frame steps: WER {wer:.4f} "
        f"(greedy {wer_greedy:.4f})")

    # ---- serving path: chunk timeline + blank collapse + two length groups
    plan = serving_plan(decoder, logits, blank_id, DEFAULT_MIN_TOKEN_LOGP)
    log(f"[serving] host prep: {plan['frames_in']} frames in, {plan['frames_kept']} after the blank "
        f"collapse (longest {plan['longest_kept']}); groups of {plan['groups']} utterances with "
        f"{plan['group_steps']} virtual steps of {CHUNK}-token chunks: {plan['steps']} steps in whole segments of "
        f"{plan['segment_frames']} (dense: {t_max} frame steps)")
    check(len(plan["groups"]) == 2, "the serving batch did not split into two length groups")
    serve_kw = dict(beam_width=BEAM, **SERVING)
    reset_counts(wrappers)
    s_texts = decoder.decode_batch(logits, **serve_kw)
    s_launches = read_counts(wrappers)
    check_counts("serving", s_launches, expected_counts([lm], plan["steps"], len(plan["groups"])))
    check(s_texts == texts, "the serving decode's texts differ from the dense decode's")
    serve_beams = decoder.decode_beams_batch(logits, **serve_kw, **beams_kw)
    d_score = check_same_results("serving vs dense", dense_beams, serve_beams, LM_SCORE_TOL)
    log(f"[serving] decode_batch {N_UTTS} x beam {BEAM}, chunks of {CHUNK}, collapse, 2 groups: texts "
        f"and text_frames equal the dense path's, max lm_score diff {d_score:.3g}")

    # the pipelined entry point, held against decode_beams_batch
    piped = pipelined("serving", decoder, [lm], logits, serve_kw, serve_beams, wrappers)

    # ---- the segments phase: the eager loop against captured graphs (dense, serving), segment sizes
    dense_call, serve_call = dict(dense_kw, **beams_kw), dict(serve_kw, **beams_kw)
    dense_by_seg = segments_case("dense", decoder, [lm], logits, dense_call, [t_max], wrappers)
    segments_case("serving", decoder, [lm], logits, serve_call, plan["group_steps"], wrappers)
    sized = segments_case("dense", decoder, [lm], logits, dense_call, [t_max], wrappers, seg_values=SEG_SIZES)
    check_same_results("dense: the other segment sizes vs the eager loop", dense_by_seg[0], sized[SEG_SIZES[0]], 0.0)
    del dense_by_seg, sized
    # the decode's end: the eager finalize and plain backtrace against the captured finalize and the kernel
    dense_bt = tail_case(torch, "dense", decoder, logits, dense_call)
    serve_bt = tail_case(torch, "serving", decoder, logits, serve_call)
    bt_cases = {"dense": dense_bt["full"], f"dense top_n={beams_kw['top_n']}": dense_bt["top"],
                "serving group": serve_bt["full"]}
    del dense_bt, serve_bt

    # ---- CPU cross-check of the first utterances (plain versions), both paths
    cpu_dec = P.TorchBeamSearchDecoderCTC(
        P.Alphabet.build_alphabet(LIBRI_LABELS), lm, device="cpu"
    )
    # the shortest utterance whole: every word commits, trigram contexts, the
    # history prune over its whole beam history and the finalize after it
    short = int(np.argmin([m.shape[0] for m in logits]))
    sub = [logits[short]]
    cpu_check = {"utterance": short, "frames": int(sub[0].shape[0])}
    for tag, kw in (("dense", dict(dense_kw, batch_pad=1)), ("serving", dict(serve_kw, batch_pad=1))):
        gpu_beams = decoder.decode_beams_batch(sub, **kw, **beams_kw)
        check(top_texts(gpu_beams) == [texts[short]], f"{tag}: batch-of-{N_UTTS} texts differ")
        cpu_beams = cpu_dec.decode_beams_batch(sub, **kw, **beams_kw)
        max_d = check_same_results(f"{tag}: GPU vs CPU", cpu_beams, gpu_beams, LM_SCORE_TOL)
        cpu_check[f"{tag}_max_lm_score_diff"] = max_d
        log(f"[check] {tag}: utterance {short} ({sub[0].shape[0]} frames, the shortest) whole, identical on CPU "
            f"(max lm_score diff {max_d:.3g})")
    del cpu_dec

    # ---- the sharded path: ShardedCTCDecoder(shard_lm=True) over a world-size-1 NCCL group
    sharded_rec = sharded_phase(torch, merge, gather, decoder, corpus, dense_beams, serve_beams)

    # ---- the evaluation harness: evaluate_corpus and compare_engines on the dense configuration
    eval_rec = evaluation_phase(torch, P, merge, gather, decoder, corpus, texts, wer_greedy)

    # ---- the hot2lm path: two LM members and hotwords (the single-LM decoder's tables go first)
    park(decoder)
    hot_rec, multi, hot = hot2lm_phase(torch, P, gather, merge, lm, corpus, vocab, wer)
    commit_cases["hot2lm"] = record_commit(torch, multi, head, 60, hotwords=hot)
    walk_cases["hot2lm"] = record_walk_batch(torch, multi, head, 60, hotwords=hot)
    park(multi)

    # ---- the bpe path: a Conformer-CTC-width piece vocabulary, dense and serving
    members = list(multi.language_model._language_models)
    bpe_dec, bpe_logits, bpe_rec = bpe_phase(torch, P, merge, gather, lm, members, hot, corpus, vocab)
    replay_cases["bpe"] = record_replay(torch, bpe_dec, [m[:61] for m in bpe_logits], 60, prune_history=False)
    commit_cases["bpe"] = record_commit(torch, bpe_dec, [m[:61] for m in bpe_logits], 60)
    walk_cases["bpe dense"] = record_walk_batch(torch, bpe_dec, [m[:61] for m in bpe_logits], 60)
    park(bpe_dec)
    bt_cases["bpe"] = bpe_rec.pop("backtrace_args")
    bt_rec = backtrace_phase(torch, bt_cases, card)
    del bt_cases
    replay_rec = replay_phase(torch, replay_cases, card)
    del replay_cases
    commit_rec = commit_phase(torch, commit_cases, card)
    del commit_cases
    walk_rec = walk_phase(torch, walk_cases, card)
    del walk_cases

    # ---- the stream path: get_starting_state / partial_decode_beams in 0.5 s chunks
    stream_rec = stream_phase(torch, P, merge, gather, {"char": decoder, "hot2lm": multi, "bpe": bpe_dec},
                              corpus, hot, bpe_logits)

    # ---- the kenlm path: decoder directories over KenLM binaries (load_from_dir), probe_rows' KenLM mode
    kenlm_rec = kenlm_phase(torch, P, merge, gather, kenlm_early, decoder, members[1], corpus, dense_beams,
                            serve_beams)
    del kenlm_early
    del decoder, multi, bpe_dec, members

    kernels = []
    for kname, src_file, r, r_serving, site in (
        ("merge_prune", "merge.cu", rec[("merge_prune", f"n={N_UTTS},k=1,window off")],
         rec[("merge_prune", f"n={GROUP_ROWS},k=1,window off")], reference_site("ops/pallas_merge.py", 213)),
        ("expand_merge_prune", "merge.cu", rec[("expand_merge_prune", f"n={N_UTTS},k={K_TOKENS},lmax=1")],
         rec[("expand_merge_prune", f"n={GROUP_ROWS},k={CHUNK},lmax=1,chunk,window off")],
         reference_site("ops/pallas_merge.py", 393)),
        ("gather_rows", "gather.cu", gather_rec["dense step: trie rows"], gather_rec["serving step: trie rows"],
         reference_site("pallas_gather_probe.py", 65)),
        ("probe_rows", "gather.cu", probe_rec["dense"], probe_rec["serving"],
         reference_site("pallas_gather_probe.py", 65)),
    ):
        errs = [v["max_abs_err"] for (n2, _), v in rec.items() if n2 == kname] + \
            ([v["max_abs_err"] for v in bpe_rec["step_kernels"].values()] if kname == "expand_merge_prune" else []) or \
            [v["max_abs_err"] for v in (probe_rec if kname == "probe_rows" else gather_rec).values()] + \
            [hot_rec["probe_member_b" if kname == "probe_rows" else "gather_member_b"]["max_abs_err"]]
        keys = ("shape", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "max_abs_err")
        errs.append(stream_rec["kernels"][kname]["max_abs_err"])
        if kname == "probe_rows":
            errs += [v["max_abs_err"] for v in kenlm_rec["probe"].values()]
        kernels.append({
            "name": kname, "route": "cuda", "source": f"pyctcdecode_torch/csrc/{src_file}",
            "replaces": site, "launches": launches[kname], "max_abs_err": max(errs),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r.get("library_ms"), "shape": r["shape"],
            "launches_serving": s_launches[kname],
            "serving": {key: r_serving.get(key) for key in keys},
            "launches_hot2lm": hot_rec["launches"][kname],
            "launches_hot2lm_serving": hot_rec["serving"]["launches"][kname],
            "launches_bpe": bpe_rec["launches"][kname],
            "launches_bpe_serving": bpe_rec["serving"]["launches"][kname],
            "launches_bpe_hot2lm": bpe_rec["hot2lm"]["launches"][kname],
            "launches_stream": stream_rec["launches"][kname],
            "launches_stream_eager": stream_rec["launches_eager"][kname],
            "launches_stream_hot2lm": stream_rec["hot2lm"]["launches"][kname],
            "launches_stream_bpe": stream_rec["bpe"]["launches"][kname],
            "stream": {key: stream_rec["kernels"][kname].get(key) for key in keys},
            "launches_kenlm": kenlm_rec["launches"][kname],
            "launches_kenlm_serving": kenlm_rec["serving"]["launches"][kname],
            "launches_sharded": sharded_rec["dense"]["launches"][kname],
            "launches_sharded_serving": sharded_rec["serving"]["launches"][kname],
            "launches_sharded_eager": sharded_rec["dense"]["eager_launches"][kname],
            "launches_evaluation": eval_rec["launches"][kname],
        })
        if kname == "expand_merge_prune":
            for tag, r_bpe in (("bpe", rec[("expand_merge_prune", f"n={N_UTTS},k={BPE_V},lmax={BPE_LMAX}")]),
                               ("bpe_serving", rec[("expand_merge_prune",
                                                    f"n={GROUP_ROWS},k={CHUNK},lmax={BPE_LMAX},chunk,window off")]),
                               ("bpe_dense_step", bpe_rec["step_kernels"]["dense"]),
                               ("bpe_serving_step", bpe_rec["step_kernels"]["serving"])):
                kernels[-1][tag] = {key: r_bpe.get(key) for key in keys}
        if kname in ("gather_rows", "probe_rows"):
            r_b = hot_rec["gather_member_b" if kname == "gather_rows" else "probe_member_b"]
            kernels[-1]["hot2lm_member_b"] = {key: r_b.get(key) for key in keys}
        if kname == "probe_rows":  # the KenLM hash mode (the FNV mode on the same queries is "ms" above)
            for tag, r_k in (("kenlm", kenlm_rec["probe"]["kenlm dense"]),
                             ("kenlm_seeded", kenlm_rec["probe"]["kenlm dense seeded"])):
                kernels[-1][tag] = {key: r_k.get(key) for key in keys + ("cold_ms", "hits")}
            kernels[-1]["row_windows"] = windows
    bt = bt_rec["dense"]
    kernels.append({
        "name": "backtrace_paths", "route": "cuda", "source": "pyctcdecode_torch/csrc/backtrace.cu",
        "replaces": f"{reference_site('engine.py', 2044)} (lax.scan in the compiled fin_fn; no Pallas kernel)",
        "launches": launches["backtrace_paths"], "max_abs_err": max(v["max_abs_err"] for v in bt_rec.values()),
        "ms": bt["ms"], "plain_ms": bt["plain_ms"], "bound_ms": bt["bound_ms"], "bound_by": bt["bound_by"],
        "library_ms": None, "shape": bt["shape"],
        "launches_serving": s_launches["backtrace_paths"], "launches_hot2lm": hot_rec["launches"]["backtrace_paths"],
        "launches_bpe": bpe_rec["launches"]["backtrace_paths"],
        "launches_stream": stream_rec["launches"]["backtrace_paths"],
        "launches_stream_eager": stream_rec["launches_eager"]["backtrace_paths"],
        "launches_kenlm": kenlm_rec["launches"]["backtrace_paths"],
        "launches_sharded": sharded_rec["dense"]["launches"]["backtrace_paths"],
        "cases": {name: {key: v.get(key) for key in ("shape", "ms", "plain_ms", "bound_ms", "bound_by")}
                  for name, v in bt_rec.items()},
    })
    rw = replay_rec["dense"]
    kernels.append({
        "name": "replay_winners", "route": "cuda", "source": "pyctcdecode_torch/csrc/replay.cu",
        "replaces": f"{reference_site('engine.py', 1290)} (XLA's lowering of the step's tail and of "
                    f"_select_fields_mxu; no Pallas kernel)",
        "launches": launches["replay_winners"], "max_abs_err": 0.0,
        "ms": rw["ms"], "plain_ms": rw["plain_ms"], "bound_ms": rw["bound_ms"], "bound_by": rw["bound_by"],
        "library_ms": None, "shape": rw["shape"],
        "launches_serving": s_launches["replay_winners"], "launches_hot2lm": hot_rec["launches"]["replay_winners"],
        "launches_bpe": bpe_rec["launches"]["replay_winners"],
        "launches_stream": stream_rec["launches"]["replay_winners"],
        "launches_stream_eager": stream_rec["launches_eager"]["replay_winners"],
        "launches_kenlm": kenlm_rec["launches"]["replay_winners"],
        "launches_sharded": sharded_rec["dense"]["launches"]["replay_winners"],
        "cases": {name: {key: v.get(key) for key in ("shape", "ms", "plain_ms", "bound_ms", "bound_by")}
                  for name, v in replay_rec.items()},
    })
    wk = walk_rec["char dense"]
    kernels.append({
        "name": "walk_partial", "route": "cuda", "source": "pyctcdecode_torch/csrc/walk.cu",
        "replaces": f"{reference_site('engine.py', 946)} (XLA's lowering of the partial-word extension walk, "
                    f"_decode_trie_cells and _partial_score; no Pallas kernel)",
        "launches": launches["walk_partial"], "max_abs_err": 0.0,
        "ms": wk["ms"], "plain_ms": wk["plain_ms"], "bound_ms": wk["bound_ms"], "bound_by": wk["bound_by"],
        "library_ms": None, "shape": wk["shape"],
        "launches_serving": s_launches["walk_partial"], "launches_hot2lm": hot_rec["launches"]["walk_partial"],
        "launches_bpe": bpe_rec["launches"]["walk_partial"],
        "launches_stream": stream_rec["launches"]["walk_partial"],
        "launches_stream_eager": stream_rec["launches_eager"]["walk_partial"],
        "launches_kenlm": kenlm_rec["launches"]["walk_partial"],
        "launches_sharded": sharded_rec["dense"]["launches"]["walk_partial"],
        "cases": {name: {key: v.get(key) for key in ("shape", "ms", "cold_ms", "plain_ms", "bound_ms", "bound_by")}
                  for name, v in walk_rec.items()},
    })
    record = {
        "kernels": kernels, "backtrace": bt_rec, "replay": replay_rec, "commit": commit_rec, "walk": walk_rec,
        "phases": {f"{a}[{b}]": v for (a, b), v in rec.items()},
        "gather_phases": gather_rec, "probe_phases": probe_rec, "probe_windows": windows,
        "main": {"utterances": N_UTTS, "beam": BEAM, "k": K_TOKENS, "frame_steps": t_max,
                 "wer": wer, "wer_greedy": wer_greedy, "launches": launches},
        "serving": dict(plan, options=SERVING, chunk=CHUNK, launches=s_launches, max_lm_score_diff_vs_dense=d_score,
                        pipelined_launches=piped),
        "cpu_check": cpu_check, "hot2lm": hot_rec, "bpe": bpe_rec, "stream": stream_rec,
        "kenlm": kenlm_rec, "native": native_rec, "sharded": sharded_rec, "evaluation": eval_rec,
        "card": smi,
        "seconds": time.perf_counter() - t_start,
    }
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "chip_smoke.json"), "w") as fh:
            json.dump(record, fh, indent=1, default=str)
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except CheckFailed as err:
        print(f"chip_smoke: FAILED: {err}", file=sys.stderr, flush=True)
        sys.exit(1)
