"""Chip smoke test: build the CUDA kernels, check them, drive the port's main path.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py [--out DIR]

Phases (any failed check exits non-zero and prints no result line):

1. device: the card's name and power limit (``nvidia-smi``);
2. build: ``nvcc`` compiles every ``pyctcdecode_torch/csrc/*.cu`` for sm_90a;
3. kernels: each CUDA kernel against its plain PyTorch version on the card,
   on random inputs made with numpy from fixed seeds, at the main path's
   shapes (N = 32 utterances, K = 29 tokens, B = 100 beams; K = 1 for the
   final text merge). Tolerances: scores and merged logits within atol 1e-5
   + rtol 1e-6 (the kernel sums exponentials in another order); ``src``
   exact at live entries; the pruned (DEAD) sets equal except within that
   tolerance of the window threshold. Times are CUDA-event medians of 30
   launches;
4. main path: the parity-scale 3-gram (200k words, 1.5M bigrams, 1.1M
   trigrams, written from a seed under ``build/``) behind
   ``pyctcdecode_torch.build_ctcdecoder``; ``decode_batch`` of 32 synthetic
   dev-other utterances at beam 100 with every token expanded (K = 29). The
   kernels' launch counters must show one ``expand_merge_prune`` launch per
   frame step and one ``merge_prune`` launch per finalization. The first 4
   utterances decode again with a ``device="cpu"`` decoder (the plain
   versions): identical texts, lm_score within 1e-3;
5. profile: one more decode under ``torch.profiler`` (device time by kernel,
   device idle share).

The last three lines are the kernel record (JSON), the ``nvidia-smi`` name and
power limit, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

LIBRI_LABELS = [" "] + list("abcdefghijklmnopqrstuvwxyz") + ["'", ""]
N_UTTS = 32
BEAM = 100
K_TOKENS = len(LIBRI_LABELS)
ATOL, RTOL = 1e-5, 1e-6
CPU_CHECK = 4
LM_SCORE_TOL = 1e-3
# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s and float32
# (non-tensor-core) operations/s; the kernels' scalar int32/f32 work is
# counted against the latter
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
REPS = 30


def log(msg: str) -> None:
    print(msg, flush=True)


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


def time_call(torch, fn, reps: int = REPS):
    """(device ms, call ms) per call of ``fn``.

    Device ms: the summed CUPTI durations of the kernels (and memsets) the
    call runs, per call, over ``reps`` calls under ``torch.profiler`` — the
    card's own time, free of Python overhead. Call ms: median CUDA-event
    time around single calls, which includes the launch gaps a caller pays.
    """
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    dev_us = sum(_device_us(ev) for ev in prof.key_averages() if _is_device_row(ev))
    check(dev_us > 0, "the profiler recorded no device time")
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


def merge_inputs(torch, dev, rng, n, k, b):
    kl = rng.randint(0, 6, size=(n, k, b)).astype(np.int64)
    kh = (kl * 2654435761) & 0xFFFFFFFF
    valid = (rng.rand(n, k, b) < 0.7).astype(np.int32)
    logit = np.where(valid, rng.randn(n, k, b) - 5.0, -1e30).astype(np.float32)
    extra = (rng.randn(n, k, b) * 2).astype(np.float32)
    prune = np.full(n, -10.0, dtype=np.float32)
    return [torch.as_tensor(a).to(dev) for a in (kl, kh, valid, logit, extra, prune)]


def expand_inputs(torch, dev, rng, n, k, b, lmax):
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
    cids = torch.as_tensor(rng.randint(-1, 31, (lmax, n, k)).astype(np.int32)).to(dev)
    pscore = torch.as_tensor((rng.randn(n, k, b) * 0.5).astype(np.float32)).to(dev)
    prune = torch.full((n,), -10.0, dtype=torch.float32, device=dev)
    return beam, tok, cids, pscore, prune


def kernel_phases(torch, merge) -> dict:
    """Each kernel vs its plain version on the card; times; bounds."""
    dev = torch.device("cuda")
    rec = {}
    for k in (K_TOKENS, 1):
        args = merge_inputs(torch, dev, np.random.RandomState(100 + k), N_UTTS, k, BEAM)
        got = merge.merge_prune(*args)
        torch.cuda.synchronize()
        err = compare(f"merge_prune[{N_UTTS},{k},{BEAM}]", got, merge.merge_prune_ref(*args), args[5])
        ms, call = time_call(torch, lambda: merge.merge_prune(*args))
        plain, plain_call = time_call(torch, lambda: merge.merge_prune_ref(*args))
        n_valid = int(args[2].sum())
        b_ms, b_by = bound_ms(nbytes(args) + nbytes(got), 3.0 * BEAM * n_valid)
        log(f"merge_prune [{N_UTTS},{k},{BEAM}]: max_abs_err {err:.3g}, kernel {ms:.4f} ms "
            f"(call {call:.4f}), plain {plain:.4f} ms (call {plain_call:.4f}), "
            f"bound {b_ms:.5f} ms ({b_by})")
        rec[("merge_prune", k)] = dict(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                                       max_abs_err=err, shape=[N_UTTS, k, BEAM],
                                       call_ms=call, plain_call_ms=plain_call)
    for lmax, is_bpe in ((1, False), (3, True)):
        beam, tok, cids, pscore, prune = expand_inputs(
            torch, dev, np.random.RandomState(200 + lmax), N_UTTS, K_TOKENS, BEAM, lmax
        )
        eargs = (beam, tok, cids, pscore, prune, is_bpe)
        got = merge.expand_merge_prune(*eargs)
        torch.cuda.synchronize()
        label = f"expand_merge_prune[{N_UTTS},{K_TOKENS},{BEAM}] lmax={lmax} bpe={is_bpe}"
        err = compare(label, got, merge.expand_merge_prune_ref(*eargs), prune)
        ms, call = time_call(torch, lambda: merge.expand_merge_prune(*eargs))
        plain, plain_call = time_call(torch, lambda: merge.expand_merge_prune_ref(*eargs))
        ins = list(beam.values()) + list(tok.values()) + [cids, pscore, prune]
        alive = beam["logit"] > -1e29
        n_valid = int((alive[:, None, :] & (tok["admit"][:, :, None] != 0)).sum())
        # pairwise key tests + ~30 scalar ops per candidate to build it
        ops = 3.0 * BEAM * n_valid + 30.0 * N_UTTS * K_TOKENS * BEAM
        b_ms, b_by = bound_ms(nbytes(ins) + nbytes(got), ops)
        log(f"{label}: max_abs_err {err:.3g}, kernel {ms:.4f} ms (call {call:.4f}), "
            f"plain {plain:.4f} ms (call {plain_call:.4f}), bound {b_ms:.5f} ms ({b_by})")
        rec[("expand_merge_prune", lmax)] = dict(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                                                 max_abs_err=err, shape=[N_UTTS, K_TOKENS, BEAM],
                                                 call_ms=call, plain_call_ms=plain_call)
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


def parity_lm(build_dir: str):
    from pyctcdecode_torch.evaluation import LM_VOCAB, make_parity_arpa, parity_vocab

    path = os.path.join(build_dir, "parity_3gram.arpa")
    if os.path.exists(path):
        return path, parity_vocab(np.random.RandomState(7), LM_VOCAB)
    tmp = path + f".tmp{os.getpid()}"
    vocab = make_parity_arpa(tmp)
    os.replace(tmp, path)
    return path, vocab


def device_profile(torch, decoder, logits, steps: int, latency_s: float) -> dict:
    """Device time by kernel over one profiled decode_batch.

    Only device rows (kernels, memsets, copies) are summed. The profiler
    slows the host a lot, so the idle share is taken against the
    unprofiled batch latency: 1 - device busy / latency.
    """
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        decoder.decode_batch(logits, beam_width=BEAM)
        torch.cuda.synchronize()
    rows = [(ev.key, _device_us(ev), int(ev.count)) for ev in prof.key_averages()
            if _is_device_row(ev) and _device_us(ev) > 0]
    rows.sort(key=lambda r: -r[1])
    busy_s = sum(r[1] for r in rows) / 1e6
    launches = sum(r[2] for r in rows)
    return {"device_busy_s": busy_s, "idle_share": 1.0 - busy_s / latency_s,
            "device_ops_per_step": launches / steps, "top": rows[:15]}


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
    from pyctcdecode_torch.csrc.build import BUILD_DIR, build
    from pyctcdecode_torch.evaluation import DEV_OTHER_DIFFICULTY, FRAME_SEC, TRANSCRIPT, synthesize_corpus
    from pyctcdecode_torch.ops import merge
    from pyctcdecode_torch.utils.metrics import word_error_rate

    smi = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    card = f"{name}, power limit {smi.split(',')[-1].strip()}"
    log(f"[device] nvidia-smi: {smi}")
    log(f"[device] torch.cuda.get_device_name(0): {name}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    libs = build(verbose=True)
    log(f"[build] {', '.join(str(p.name) for p in libs.values())} in {time.perf_counter() - t0:.2f} s")

    rec = kernel_phases(torch, merge)

    # ---- main path
    t0 = time.perf_counter()
    arpa, vocab = parity_lm(str(BUILD_DIR))
    log(f"[main] parity ARPA ready in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    decoder = P.build_ctcdecoder(LIBRI_LABELS, arpa)
    log(f"[main] build_ctcdecoder (parse + device tables) in {time.perf_counter() - t0:.1f} s")
    check(decoder.device.type == "cuda", "decoder is not on CUDA")
    rng = np.random.RandomState(11)
    corpus_vocab = [vocab[i] for i in rng.randint(0, len(vocab), 6000)] + TRANSCRIPT.split()
    corpus = synthesize_corpus(LIBRI_LABELS, corpus_vocab, n_utterances=N_UTTS, seed=3,
                               **DEV_OTHER_DIFFICULTY)
    logits = corpus.logits
    t_max = max(m.shape[0] for m in logits)
    audio_s = corpus.audio_seconds
    log(f"[main] corpus: {N_UTTS} utterances, {audio_s:.2f} audio-s, frames "
        f"{min(m.shape[0] for m in logits)}..{t_max}")

    t0 = time.perf_counter()
    decoder.decode_batch(logits[:2], beam_width=BEAM)  # first-use set-up (library load)
    log(f"[main] warm-up decode of 2 utterances in {time.perf_counter() - t0:.2f} s")

    merge.merge_prune.launches = 0
    merge.expand_merge_prune.launches = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    texts = decoder.decode_batch(logits, beam_width=BEAM, max_tokens_per_frame=None)
    latencies = [time.perf_counter() - t0]
    launches = {"merge_prune": merge.merge_prune.launches,
                "expand_merge_prune": merge.expand_merge_prune.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for _ in range(2):
        t0 = time.perf_counter()
        again = decoder.decode_batch(logits, beam_width=BEAM, max_tokens_per_frame=None)
        latencies.append(time.perf_counter() - t0)
        check(again == texts, "repeated decode_batch gave other texts")
    latency = statistics.median(latencies)
    log(f"[main] launches in the main-path run: {launches} (frame steps {t_max})")
    check(launches["expand_merge_prune"] == t_max, "expand_merge_prune: not one launch per frame step")
    check(launches["merge_prune"] == 1, "merge_prune: not one launch per finalization")
    wer = word_error_rate(corpus.references, texts)
    greedy = []
    for m in logits:
        ids = m.argmax(axis=1)
        keep = np.concatenate([[True], ids[1:] != ids[:-1]])
        greedy.append(" ".join("".join(LIBRI_LABELS[i] for i in ids[keep]).split()))
    wer_greedy = word_error_rate(corpus.references, greedy)
    log(f"[main] decode_batch {N_UTTS} x beam {BEAM}, K {K_TOKENS}: latency median {latency:.3f} s "
        f"of {', '.join(f'{x:.3f}' for x in latencies)}, {audio_s / latency:.1f} audio-s/s, "
        f"{latency / t_max * 1e3:.2f} ms per frame step, peak device memory {peak_gb:.3f} GB, "
        f"WER {wer:.4f} (greedy {wer_greedy:.4f}) [{card}]")
    check(all(isinstance(t, str) for t in texts) and len(texts) == N_UTTS, "bad decode_batch output")

    # ---- CPU cross-check of the first utterances (plain versions)
    t0 = time.perf_counter()
    cpu_dec = P.TorchBeamSearchDecoderCTC(
        P.Alphabet.build_alphabet(LIBRI_LABELS), decoder.language_model, device="cpu"
    )
    sub = logits[:CPU_CHECK]
    kw = dict(beam_width=BEAM, prune_history=True, top_n=1, batch_pad=1)
    gpu_beams = decoder.decode_beams_batch(sub, **kw)
    cpu_beams = cpu_dec.decode_beams_batch(sub, **kw)
    for i, (g, c) in enumerate(zip(gpu_beams, cpu_beams)):
        check(g[0].text == c[0].text, f"utterance {i}: GPU and CPU texts differ")
        check(g[0].text == texts[i], f"utterance {i}: batch-of-{N_UTTS} text differs")
        d = abs(g[0].lm_score - c[0].lm_score)
        check(d <= LM_SCORE_TOL, f"utterance {i}: lm_score differs by {d}")
    max_d = max(abs(g[0].lm_score - c[0].lm_score) for g, c in zip(gpu_beams, cpu_beams))
    log(f"[check] first {CPU_CHECK} utterances identical on CPU (max lm_score diff {max_d:.3g}) "
        f"in {time.perf_counter() - t0:.1f} s")

    # ---- where the device time goes
    prof = device_profile(torch, decoder, logits, t_max, latency)
    log(f"[profile] device busy {prof['device_busy_s']:.3f} s of the {latency:.3f} s batch: "
        f"idle share {prof['idle_share']:.3f}; {prof['device_ops_per_step']:.0f} device ops per "
        f"frame step [{card}]")
    for key, us, count in prof["top"]:
        log(f"[profile]   {us / 1e3:9.2f} ms  x{count:6d}  {key[:100]}")

    kernels = []
    for kname, key, source_line in (
        ("merge_prune", ("merge_prune", 1), reference_site("ops/pallas_merge.py", 213)),
        ("expand_merge_prune", ("expand_merge_prune", 1), reference_site("ops/pallas_merge.py", 393)),
    ):
        r = rec[key]
        errs = [v["max_abs_err"] for (n2, _), v in rec.items() if n2 == kname]
        kernels.append({
            "name": kname, "route": "cuda", "source": "pyctcdecode_torch/csrc/merge.cu",
            "replaces": source_line, "launches": launches[kname], "max_abs_err": max(errs),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None, "shape": r["shape"],
        })
    record = {
        "kernels": kernels,
        "phases": {f"{a}[k={b}]" if a == "merge_prune" else f"{a}[lmax={b}]": v for (a, b), v in rec.items()},
        "main": {"utterances": N_UTTS, "beam": BEAM, "k": K_TOKENS, "frame_steps": t_max,
                 "audio_s": audio_s, "latency_s": latency, "latencies_s": latencies,
                 "audio_s_per_s": audio_s / latency, "peak_device_gb": peak_gb,
                 "wer": wer, "wer_greedy": wer_greedy, "frame_sec": FRAME_SEC},
        "profile": prof, "card": smi, "seconds": time.perf_counter() - t_start,
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
