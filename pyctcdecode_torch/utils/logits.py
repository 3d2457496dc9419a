"""Input normalization: accept probabilities, logits, or log-probs.

Parity surface: ref ``decoder.py:180-197, 699-705, 759-765``. Rows summing to
~1 are treated as probabilities (log + clip); anything else goes through a
clipped log-softmax. Host-side numpy: the decoder uploads the normalized
float32 log-probs once per call. :func:`normalize_to_logp_torch` is the
same normalization in torch ops, on the tensor's own device.

The serving path's host prep lives here too, all numpy over the batch's
concatenated frame axis: :func:`blank_collapse` (drop blank-certain frames),
:func:`token_timeline` (split each frame's admitted token set into K-wide
chunks) and their whole-batch forms, run over utterance chunks on a shared
thread pool.
"""
from __future__ import annotations

import math
import threading

import numpy as np
import torch

from ..constants import MIN_TOKEN_CLIP_P


def log_softmax_np(x: np.ndarray, axis: int = -1) -> np.ndarray:
    """Numerically stable log-softmax (scipy-equivalent, non-finite-max safe)."""
    x_max = np.amax(x, axis=axis, keepdims=True)
    if x_max.ndim > 0:
        x_max[~np.isfinite(x_max)] = 0
    elif not np.isfinite(x_max):
        x_max = 0
    shifted = x - x_max
    with np.errstate(divide="ignore"):
        log_z = np.log(np.sum(np.exp(shifted), axis=axis, keepdims=True))
    return shifted - log_z


def normalize_to_logp(logits: np.ndarray) -> np.ndarray:
    """Sniff the input domain and return clipped log-probabilities."""
    with np.errstate(invalid="ignore"):
        row_sum_mean = float(logits.sum(axis=1).mean()) if logits.size else float("nan")
    if math.isclose(row_sum_mean, 1):
        # probabilities
        return np.log(np.clip(logits, MIN_TOKEN_CLIP_P, 1))
    # raw logits (or already log-probs; log-softmax is idempotent-enough and
    # matches the reference behavior exactly)
    return np.clip(log_softmax_np(logits, axis=1), math.log(MIN_TOKEN_CLIP_P), 0)


def normalize_to_logp_torch(logits: torch.Tensor, assume: str = "auto") -> torch.Tensor:
    """Torch twin of :func:`normalize_to_logp` on ``logits``' own device, with no host sync.

    ``assume`` may be ``"auto"`` (the probabilities sniff as a device-side
    ``torch.where``: the mean row sum close to 1 at rtol 1e-9), ``"probs"``,
    ``"logits"`` or ``"logp"`` to skip the sniff when the caller knows the
    domain. Log-probabilities are clipped at ``log(MIN_TOKEN_CLIP_P)``.
    """
    if assume == "logp":
        return logits
    floor = math.log(MIN_TOKEN_CLIP_P)
    if assume == "probs":
        return torch.log(logits.clamp(MIN_TOKEN_CLIP_P, 1.0))
    as_logits = torch.log_softmax(logits, dim=-1).clamp(floor, 0.0)
    if assume == "logits":
        return as_logits
    as_probs = torch.log(logits.clamp(MIN_TOKEN_CLIP_P, 1.0))
    row_sum_mean = logits.sum(dim=-1).mean()
    is_probs = torch.isclose(row_sum_mean, torch.ones_like(row_sum_mean), rtol=1e-9, atol=0.0)
    return torch.where(is_probs, as_probs, as_logits)


def blank_collapse(
    logp: np.ndarray, blank_id: int, token_min_logp: float
) -> tuple:
    """Frame indices to keep after collapsing blank-certain runs.

    A frame is *droppable* when blank is its argmax and every other token's
    log-prob is below ``token_min_logp``: the decoder's admission rule
    (threshold OR argmax, ref decoder.py:444-445) then admits only the
    blank "stay" transition, which maps every beam to itself with a score
    shift that is uniform across beams. Runs of droppable frames keep
    their FIRST frame (it performs the blank-path beam merge and the
    last-token reset that separates repeated characters — dropping it
    would change results); the rest are removed.

    Decoded text, ranking, frame spans (via the returned original frame
    ids) and pruning decisions are exactly those of the full decode;
    adding the returned ``dropped_sum`` (the dropped frames' blank
    log-probs) to each output score reconstructs full-decode scores up to
    f32 summation order. The technique follows "Blank Collapse:
    Compressing CTC emission for the faster decoding" (arXiv:2210.17017);
    the condition here is the stronger exactness-preserving one.

    Returns ``(keep_idx int64 [T'], dropped_sum float)``.
    """
    t = logp.shape[0]
    if t == 0:
        return np.arange(0, dtype=np.int64), 0.0
    amax = logp.argmax(axis=1)
    second = np.partition(logp, -2, axis=1)[:, -2]
    droppable = (amax == blank_id) & (second < token_min_logp)
    keep = ~droppable | np.concatenate([[True], ~droppable[:-1]])
    keep_idx = np.flatnonzero(keep).astype(np.int64)
    dropped_sum = float(logp[~keep, blank_id].sum())
    return keep_idx, dropped_sum


def token_timeline(
    logp: np.ndarray, token_min_logp: float, k_chunk: int
) -> tuple:
    """Split each frame's exactly-admitted token set into K-wide chunks.

    The decoder admits token ``v`` at frame ``t`` when ``logp[t, v] >=
    token_min_logp`` OR ``v`` is the frame's argmax (ref decoder.py:
    444-445). Dense engines pay a static per-frame token width K sized to
    the WORST frame of the batch, while the mean admitted count on real
    CTC emissions is 2-6; this function turns each frame into
    ``ceil(admitted / k_chunk)`` *virtual frames* of exactly the admitted
    token ids, in ascending-id order (the reference's enumeration order).
    The engine processes virtual frames with a carried candidate pool and
    promotes the pool to the new beam set on each frame's last chunk —
    output-exact, because candidate merges are confined to one applied-
    token column (so chunks never split a merge group) and an iterated
    top-B over ``pool ∪ chunk`` equals the top-B of the frame's full
    candidate set.

    Returns ``(toks [Tv, K] int32 (-1 padded), tlogp [Tv, K] f32,
    is_final [Tv] bool, chunk_base [Tv] int32 (admitted tokens before the
    chunk), frame_ids [Tv] int32 (owning original frame))``.
    """
    t, v = logp.shape
    k_chunk = int(k_chunk)
    if t == 0:
        z = np.zeros((0, k_chunk), dtype=np.int32)
        return (z, z.astype(np.float32), np.zeros(0, bool),
                np.zeros(0, np.int32), np.zeros(0, np.int32))
    admit = logp >= token_min_logp
    admit[np.arange(t), logp.argmax(axis=1)] = True
    flat = np.flatnonzero(admit)  # sorted by (frame, token id)
    frame_of = flat // v
    counts = admit.sum(axis=1)  # >= 1 per frame
    # position of each admitted token within its frame
    starts = np.zeros(t, dtype=np.int64)
    np.cumsum(counts[:-1], out=starts[1:])
    pos = np.arange(flat.size) - starts[frame_of]
    chunk_of = pos // k_chunk  # chunk index within the frame
    chunks_per_frame = -(-counts // k_chunk)
    tv = int(chunks_per_frame.sum())
    # virtual step of each admitted token
    vstarts = np.zeros(t, dtype=np.int64)
    np.cumsum(chunks_per_frame[:-1], out=vstarts[1:])
    vstep = vstarts[frame_of] + chunk_of
    slot = pos - chunk_of * k_chunk
    toks = np.full((tv, k_chunk), -1, dtype=np.int32)
    tlogp = np.zeros((tv, k_chunk), dtype=np.float32)
    toks[vstep, slot] = (flat % v).astype(np.int32)
    tlogp[vstep, slot] = logp[frame_of, flat % v]
    frame_ids = np.zeros(tv, dtype=np.int32)
    frame_ids[vstarts] = 1
    frame_ids = np.cumsum(frame_ids) - 1
    is_final = np.zeros(tv, dtype=bool)
    is_final[vstarts + chunks_per_frame - 1] = True
    chunk_base = (
        (np.arange(tv) - vstarts[frame_ids]) * k_chunk
    ).astype(np.int32)
    return toks, tlogp, is_final, chunk_base.astype(np.int32), frame_ids


def _ragged_bounds(lens: "object") -> np.ndarray:
    """Exclusive prefix bounds of a ragged batch: ``[0, l0, l0+l1, ...]``."""
    bounds = np.zeros(len(lens) + 1, dtype=np.int64)
    np.cumsum(lens, out=bounds[1:])
    return bounds


_HOST_POOL = None
_HOST_POOL_WORKERS = 1
_HOST_POOL_LOCK = threading.Lock()


def _host_pool():
    """Shared thread pool for batch host prep (numpy releases the GIL).

    Sized to the machine's cores minus one (the main thread keeps
    dispatching device work). Threads, not processes: the work is numpy
    C loops over large arrays, and the inputs would be expensive to pickle.
    Created lazily under a lock (concurrent first calls from two decoder
    threads must not leak a second executor); never shut down — the
    workers are idle daemons for the process lifetime.
    """
    global _HOST_POOL, _HOST_POOL_WORKERS
    if _HOST_POOL is None:
        import os
        from concurrent.futures import ThreadPoolExecutor

        with _HOST_POOL_LOCK:
            if _HOST_POOL is None:
                _HOST_POOL_WORKERS = max((os.cpu_count() or 2) - 1, 1)
                _HOST_POOL = ThreadPoolExecutor(
                    max_workers=_HOST_POOL_WORKERS
                )
    return _HOST_POOL


def _parallel_over_chunks(fn, mats, min_chunk: int = 64):
    """Run ``fn(chunk_of_mats)`` over utterance chunks on the host pool.

    Returns the per-chunk results in order. Falls back to one direct call
    for small batches (thread overhead beats the win below ~2 chunks).
    """
    pool = _host_pool()
    workers = _HOST_POOL_WORKERS
    n = len(mats)
    if workers < 2 or n < 2 * min_chunk:
        return [fn(mats)]
    per = max(min_chunk, -(-n // workers))
    chunks = [mats[i : i + per] for i in range(0, n, per)]
    return list(pool.map(fn, chunks))


def _normalize_cat(mats: "object") -> tuple:
    """Normalize a ragged batch over its concatenated frame axis.

    Exactly equivalent to ``[normalize_to_logp(m).astype(f32) for m in
    mats]``, with the per-utterance prob/logit sniff preserved
    bit-for-bit, but the expensive branches run vectorized over all
    frames at once. Returns ``(out [sum_T, V] f32, bounds [n+1],
    lens [n], nz [n] bool)``.

    The fast concatenated path only applies to float32 inputs: the sniff
    and the normalization arithmetic are dtype-sensitive (a float64
    probability matrix cast to f32 first can flip the isclose row-sum
    sniff and must be log-clipped at f64 like the scalar path), so other
    dtypes go through ``normalize_to_logp`` per utterance.
    """
    mats = [np.asarray(m) for m in mats]
    n = len(mats)
    lens = np.array([m.shape[0] for m in mats], dtype=np.int64)
    bounds = _ragged_bounds(lens)
    nz = lens > 0
    if any(m.dtype != np.float32 for m in mats):
        outs = [
            normalize_to_logp(m).astype(np.float32).reshape(m.shape)
            for m in mats
        ]
        v = outs[0].shape[1] if outs[0].ndim == 2 else 0
        cat = np.concatenate([o.reshape(-1, v) for o in outs], axis=0)
        return cat, bounds, lens, nz
    v = mats[0].shape[1] if mats[0].ndim == 2 else 0
    cat = np.concatenate([m.reshape(-1, v) for m in mats], axis=0)
    with np.errstate(invalid="ignore"):
        row_sums = cat.sum(axis=1)  # identical per-row f32 sums
    is_probs = np.zeros(n, dtype=bool)
    for i in range(n):
        # per-slice np.mean reproduces normalize_to_logp's f32 pairwise
        # mean bit-for-bit (the isclose sniff sits at f32 resolution, so
        # summation order matters)
        if lens[i]:
            mean = float(row_sums[bounds[i] : bounds[i + 1]].mean())
            is_probs[i] = math.isclose(mean, 1)
    probs_rows = np.repeat(is_probs, lens)

    out = np.empty_like(cat)
    floor = np.float32(math.log(MIN_TOKEN_CLIP_P))
    if probs_rows.any():
        with np.errstate(divide="ignore"):
            out[probs_rows] = np.log(
                np.clip(cat[probs_rows], MIN_TOKEN_CLIP_P, 1.0)
            )
    if (~probs_rows).any():
        x = cat[~probs_rows]
        out[~probs_rows] = np.clip(log_softmax_np(x, axis=1), floor, 0.0)
    return out, bounds, lens, nz


def normalize_batch(mats: "object") -> list:
    """Vectorized ``[normalize_to_logp(m).astype(f32) for m in mats]``.

    Parallelized over utterance chunks on the host thread pool.
    """
    if not len(mats):
        return []

    def one(chunk):
        out, bounds, _, _ = _normalize_cat(chunk)
        return [out[bounds[i] : bounds[i + 1]] for i in range(len(chunk))]

    res: list = []
    for part in _parallel_over_chunks(one, list(mats)):
        res.extend(part)
    return res


def normalize_collapse_batch(
    mats: "object", blank_id: int, token_min_logp: float
) -> tuple:
    """Parallel wrapper over :func:`_normalize_collapse_chunk` (bit-equal:
    every step is per-utterance)."""
    collapsed: list = []
    keep: list = []
    offs: list = []
    parts = _parallel_over_chunks(
        lambda ch: _normalize_collapse_chunk(ch, blank_id, token_min_logp),
        list(mats),
    )
    for c, k, o in parts:
        collapsed.extend(c)
        keep.extend(k)
        offs.extend(o)
    return collapsed, keep, offs


def _normalize_collapse_chunk(
    mats: "object", blank_id: int, token_min_logp: float
) -> tuple:
    """Normalize + blank-collapse a ragged batch in whole-batch passes.

    Exactly equivalent to ``[normalize_to_logp(m) for m in mats]`` followed
    by per-utterance :func:`blank_collapse` (the per-utterance prob/logit
    sniff included), but every step runs vectorized over the concatenated
    frame axis — the per-utterance Python loop dominated one-shot host
    prep at serving batch sizes (768 x ~6 numpy calls each).

    Returns ``(collapsed list, keep_idx list, offsets list)`` matching
    ``TorchBeamSearchDecoderCTC._collapse_all``.
    """
    n = len(mats)
    if n == 0:
        return [], [], []
    out, bounds, lens, nz = _normalize_cat(mats)
    v = out.shape[1]
    total = out.shape[0]

    # blank-collapse over the concatenated frames, run heads kept per
    # utterance (frame 0 of each utterance has no predecessor)
    if total:
        amax = out.argmax(axis=1)
        second = (
            np.partition(out, -2, axis=1)[:, -2]
            if v >= 2
            else np.full(total, -np.inf, dtype=np.float32)
        )
        droppable = (amax == blank_id) & (second < token_min_logp)
        prev_drop = np.empty(total, dtype=bool)
        prev_drop[0] = False
        prev_drop[1:] = droppable[:-1]
        prev_drop[bounds[:-1][nz]] = False
        keep = ~droppable | ~prev_drop
    collapsed, keep_idx_list, offsets = [], [], []
    for i in range(n):
        lo, hi = bounds[i], bounds[i + 1]
        if lo == hi:
            collapsed.append(out[lo:hi])
            keep_idx_list.append(np.arange(0, dtype=np.int64))
            offsets.append(0.0)
            continue
        rel = np.flatnonzero(keep[lo:hi]).astype(np.int64)
        collapsed.append(out[lo:hi][rel])
        keep_idx_list.append(rel)
        # same summation set and order as blank_collapse's dropped_sum
        offsets.append(float(out[lo:hi][~keep[lo:hi], blank_id].sum()))
    return collapsed, keep_idx_list, offsets


def token_timeline_batch(
    mats: "object", token_min_logp: float, k_chunk: int
) -> tuple:
    """Parallel wrapper over :func:`_token_timeline_chunk`."""
    tls: list = []
    vlens_parts: list = []
    parts = _parallel_over_chunks(
        lambda ch: _token_timeline_chunk(ch, token_min_logp, k_chunk),
        list(mats),
    )
    for t, v in parts:
        tls.extend(t)
        vlens_parts.append(v)
    return tls, (
        np.concatenate(vlens_parts) if vlens_parts else np.zeros(0, np.int64)
    )


def _token_timeline_chunk(
    mats: "object", token_min_logp: float, k_chunk: int
) -> tuple:
    """Whole-batch :func:`token_timeline`: one vectorized pass, no per-utt loop.

    ``mats`` are already-normalized log-prob matrices (ragged). Returns
    ``(timelines, vlens)`` where ``timelines[i]`` is exactly
    ``token_timeline(mats[i], token_min_logp, k_chunk)`` and ``vlens[i]``
    its virtual step count — built by concatenating the batch's frames,
    running the admit/chunk arithmetic once, and splitting per utterance.
    """
    n = len(mats)
    k_chunk = int(k_chunk)
    if n == 0:
        return [], np.zeros(0, dtype=np.int64)
    mats = [np.asarray(m, dtype=np.float32) for m in mats]
    v = mats[0].shape[1]
    lens = np.array([m.shape[0] for m in mats], dtype=np.int64)
    bounds = _ragged_bounds(lens)
    cat = np.concatenate([m.reshape(-1, v) for m in mats], axis=0)
    t_total = cat.shape[0]
    if t_total == 0:
        z = np.zeros((0, k_chunk), dtype=np.int32)
        empty = (z, z.astype(np.float32), np.zeros(0, bool),
                 np.zeros(0, np.int32), np.zeros(0, np.int32))
        return [empty] * n, np.zeros(n, dtype=np.int64)

    admit = cat >= token_min_logp
    admit[np.arange(t_total), cat.argmax(axis=1)] = True
    counts = admit.sum(axis=1)  # >= 1 per frame
    chunks_per_frame = -(-counts // k_chunk)
    # per-frame owning utterance and per-utterance virtual-step extents
    utt_of_frame = np.repeat(np.arange(n, dtype=np.int64), lens)
    vlens = np.zeros(n, dtype=np.int64)
    nz = lens > 0
    if nz.any():
        vlens[nz] = np.add.reduceat(chunks_per_frame, bounds[:-1][nz])
    vbounds = _ragged_bounds(vlens)
    tv_total = int(vbounds[-1])

    # global admitted-token coordinates (same arithmetic as token_timeline)
    flat = np.flatnonzero(admit)
    frame_of = flat // v
    starts = np.zeros(t_total, dtype=np.int64)
    np.cumsum(counts[:-1], out=starts[1:])
    pos = np.arange(flat.size) - starts[frame_of]
    chunk_of = pos // k_chunk
    vstarts = np.zeros(t_total, dtype=np.int64)  # global virtual start/frame
    np.cumsum(chunks_per_frame[:-1], out=vstarts[1:])
    vstep = vstarts[frame_of] + chunk_of  # global virtual step per token
    slot = pos - chunk_of * k_chunk

    toks_flat = np.full((tv_total, k_chunk), -1, dtype=np.int32)
    tlogp_flat = np.zeros((tv_total, k_chunk), dtype=np.float32)
    tok_ids = (flat % v).astype(np.int32)
    toks_flat[vstep, slot] = tok_ids
    tlogp_flat[vstep, slot] = cat[frame_of, flat % v]
    is_final_flat = np.zeros(tv_total, dtype=bool)
    is_final_flat[vstarts + chunks_per_frame - 1] = True
    # owning local frame id per virtual step
    heads = np.zeros(tv_total, dtype=np.int64)
    heads[vstarts] = 1
    gframe = np.cumsum(heads) - 1  # global frame per virtual step
    frame_local = gframe - bounds[:-1][utt_of_frame[gframe]]
    cbase_flat = (
        (np.arange(tv_total) - vstarts[gframe]) * k_chunk
    ).astype(np.int32)

    timelines = []
    for i in range(n):
        lo, hi = vbounds[i], vbounds[i + 1]
        timelines.append(
            (
                toks_flat[lo:hi],
                tlogp_flat[lo:hi],
                is_final_flat[lo:hi],
                cbase_flat[lo:hi],
                frame_local[lo:hi].astype(np.int32),
            )
        )
    return timelines, vlens
