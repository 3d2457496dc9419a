"""The engine step's word commit: one CUDA kernel and its plain twin.

:func:`commit_words` answers, for every beam of a decode step, what
committing its partial word would do: the text hash with the word folded
in, the fused word score (each LM member's ``alpha * raw10 * ln 10 + beta``
with its OOV offset, summed in member order and divided by the member count,
plus the hotword gain) and each member's new context (ids, length, suffix
backoffs). Each member's ``raw10`` is KenLM's ``BaseScore`` of the word after
the beam's context: the order-1 probe rides the beam's trie row, every order
>= 2 is a bucket probe of the member's n-gram tables, and the longest match
and the backoffs of the unmatched context suffixes give the score. A beam
without a partial word keeps its text and contexts and scores 0 (plus the
hotword gain, which is 0 without a commit).

The JAX reference computes this as XLA's lowering of its ``_commit_quantities``
(``engine.py:450``), with the probes in ``lm_score_words_jnp``; no Pallas
kernel. The port ran it as about 90 small kernels a step on the card around
the one ``probe_rows`` launch (:func:`commit_words_ref`, the composition),
each over the ``[N, B]`` beams and each bound by its launch, not its bytes.

What bounds it on the H100: launch latency, then the bucket rows: a 32 x 100
step reads one 512-byte row per beam and table (~3 MB for a 3-gram, under
1 us at 3.35 TB/s) and writes a few bytes per beam. The kernel
(``commit_words_kernel`` in ``csrc/gather.cu``, beside ``probe_rows_kernel``,
whose hashing and row readout it shares) runs one warp per beam: every
lane loads its 16-byte vector of each table's row, all loads issued before
any is read, and the probes' answers never leave registers. It rounds every
f32 operation as the composition's separate PyTorch kernels round it, in the
same order, and hashes in uint32, so it equals the composition on the card
to the bit. One detail follows PyTorch's CUDA kernels rather than its CPU
ones: a true division by a host scalar (the members' mean) multiplies by the
scalar's f32 reciprocal there; for one or two members the two agree.

The kernel takes every member set the engine runs except three, which keep
the composition (:func:`commit_kernel_fits` chooses from the tables): tables
row-sharded over processes (their probe is collective,
:func:`~pyctcdecode_torch.models.device_tables.probe_rows_sharded`), a
member of order 1 (no table to probe), and more than
:data:`~pyctcdecode_torch.ops.gather.PROBE_MAX_TABLES` probe tables over all
members.

On CPU tensors :func:`commit_words` runs :func:`commit_words_ref`; on CUDA
tensors it launches the kernel or raises. ``commit_words.launches`` counts
kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..constants import LOG_BASE_CHANGE_FACTOR
from ..models.device_tables import _BUCKET_SLOTS, _SUB_WIDTH, HOT_WORD_BIT, DeviceLM, lm_score_words
from .gather import PROBE_GEOMETRY, PROBE_MAX_TABLES, hash_mode_code
from .hashing import M32, hash_text_commit_t
from .merge import _check, _launch, _launch_device, _ptr

MAX_MEMBERS = 8  # LM members the kernel's launch struct holds

_LOG10 = float(np.float32(LOG_BASE_CHANGE_FACTOR))
_BIT_IN_VOCAB = DeviceLM.BIT_IN_VOCAB
_BIT_UNI_WORD = DeviceLM.BIT_UNI_WORD


# --------------------------------------------------------------------------
# the plain PyTorch composition
# --------------------------------------------------------------------------
def member_word_score(lm: Dict, lm_prm: Dict, trie_row, flags, ctx, ctx_len, ctx_bo,
                      stats_out: Optional[Dict] = None):
    """Fused word score + new context for each beam's committed partial.

    ``flags`` are the node's packed entry bits carried on the beam; the word
    id and its order-1 probe ride the beam's trie row (last four columns).
    ``stats_out`` receives the probes' per-order hit masks.
    """
    in_model = (flags & _BIT_IN_VOCAB) != 0
    wid = torch.where(in_model, trie_row[..., -1].to(torch.int64), lm["unk_id"])
    unk = lm["uni_unk_row"]
    f1 = torch.where(in_model, trie_row[..., -2] != 0, unk[2] > 0.5)
    t_p = trie_row[..., -4].contiguous().view(torch.float32)
    t_b = trie_row[..., -3].contiguous().view(torch.float32)
    p1 = torch.where(f1, torch.where(in_model, t_p, unk[0]), 0.0)
    b1 = torch.where(f1, torch.where(in_model, t_b, unk[1]), 0.0)
    in_uni = (flags & _BIT_UNI_WORD) != 0
    is_oov = ~in_model
    if lm["has_unigrams"]:
        is_oov = is_oov | ~in_uni
    raw10, new_ctx, new_ctx_len, new_bo = lm_score_words(
        lm, ctx, ctx_len, wid, ctx_bo, uni_probe=(f1, p1, b1), stats_out=stats_out
    )
    raw10 = raw10 + lm_prm["unk_offset"] * is_oov.to(torch.float32)
    fused = lm_prm["alpha"] * raw10 * _LOG10 + lm_prm["beta"]
    return fused, new_ctx, new_ctx_len, new_bo


def hot_gain(prm: Dict, h_bits: torch.Tensor, commit: torch.Tensor) -> torch.Tensor:
    """Full-word hotword boost at commit (ref language_model.py:137-139)."""
    is_hot_word = (h_bits & HOT_WORD_BIT) != 0
    return prm["hot_weight"] * (is_hot_word & commit).to(torch.float32)


def commit_words_ref(lms: List[Dict], prm: Dict, state: Dict, trie_rows: List[torch.Tensor],
                     use_hot: bool, collect_stats: bool) -> Dict:
    """Plain version of :func:`commit_words` (any device; any member set)."""
    commit = state["p_len"] > 0
    t_lo, t_hi = hash_text_commit_t(
        state["text_lo"], state["text_hi"], state["p_lo"], state["p_hi"]
    )
    out = {
        "text_lo": torch.where(commit, t_lo, state["text_lo"]),
        "text_hi": torch.where(commit, t_hi, state["text_hi"]),
    }
    fused_sum = None
    c2 = commit[..., None]
    if collect_stats:
        out["probe_hits"] = []
    for i, lm in enumerate(lms):
        member_stats: Optional[Dict] = {} if collect_stats else None
        fused, new_ctx, new_ctx_len, new_bo = member_word_score(
            lm, prm["lm"][i], trie_rows[i], state[f"p_flags{i}"], state[f"ctx{i}"],
            state[f"ctx_len{i}"], state[f"ctx_bo{i}"], member_stats,
        )
        if collect_stats:
            out["probe_hits"].append(member_stats["hits"])
        fused_sum = fused if fused_sum is None else fused_sum + fused
        out[f"ctx{i}"] = torch.where(c2, new_ctx, state[f"ctx{i}"])
        out[f"ctx_len{i}"] = torch.where(commit, new_ctx_len, state[f"ctx_len{i}"])
        out[f"ctx_bo{i}"] = torch.where(c2, new_bo, state[f"ctx_bo{i}"])
    if fused_sum is None:
        word_fused = torch.zeros_like(state["fused"])
    else:
        if len(lms) > 1:
            fused_sum = fused_sum / len(lms)
        word_fused = torch.where(commit, fused_sum, 0.0)
    if use_hot:
        word_fused = word_fused + hot_gain(prm, state["h_bits"], commit)
    out["word_fused"] = word_fused
    return out


def commit_kernel_fits(lms: Sequence[Dict]) -> bool:
    """Whether :func:`commit_words`' kernel takes these members' tables.

    It takes up to :data:`MAX_MEMBERS` members of order >= 2 whose tables are
    whole on this process, with at most ``PROBE_MAX_TABLES`` probe tables in
    all. Row-sharded tables (``"shard"``), an order-1 member and more tables
    keep the composition.
    """
    if len(lms) > MAX_MEMBERS:
        return False
    if any("shard" in lm or lm["order"] < 2 for lm in lms):
        return False
    return sum(len(lm["fp"]) for lm in lms) <= PROBE_MAX_TABLES


# --------------------------------------------------------------------------
# the kernel's launch struct (``csrc/gather.cu`` ``CommitArgs``)
# --------------------------------------------------------------------------
_P = ctypes.c_void_p
_U32S = ctypes.c_uint32 * PROBE_MAX_TABLES


class _ProbeTables(ctypes.Structure):
    _fields_ = [("bucket", _P * PROBE_MAX_TABLES)] + [
        (name, _U32S) for name in ("size", "row0", "rows", "seed_lo", "seed_hi", "mode")]


class _CommitKey(ctypes.Structure):
    _fields_ = [(name, _P) for name in ("ctx", "ctx_len", "ctx_bo", "p_flags", "trie_row")] + [
        ("unk_id", ctypes.c_int64), ("w", ctypes.c_int), ("row_w", ctypes.c_int), ("n", ctypes.c_int)]


class _CommitMember(ctypes.Structure):
    _fields_ = ([("key", _CommitKey)]
                + [(name, _P) for name in ("uni_unk_row", "alpha", "beta", "unk_offset",
                                           "o_ctx", "o_ctx_len", "o_ctx_bo", "o_hits")]
                + [(name, ctypes.c_float) for name in ("alpha_v", "beta_v", "unk_offset_v", "unk_prob10")]
                + [(name, ctypes.c_int) for name in ("order", "t0", "has_unigrams")])


class _CommitArgs(ctypes.Structure):
    _fields_ = ([("tabs", _ProbeTables), ("keys", _CommitKey * PROBE_MAX_TABLES),
                 ("m", _CommitMember * MAX_MEMBERS)]
                + [(name, _P) for name in ("text_lo", "text_hi", "p_lo", "p_hi", "p_len", "h_bits",
                                           "hot_weight", "o_text_lo", "o_text_hi", "o_word_fused")]
                + [(name, ctypes.c_int64) for name in ("bit_in_vocab", "bit_uni_word", "hot_word_bit")]
                + [("hot_weight_v", ctypes.c_float), ("ln10", ctypes.c_float), ("nb", ctypes.c_longlong)]
                + [(name, ctypes.c_int) for name in ("n_lms", "n_tables", "stats")])


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    """Build (first use) and load ``csrc/gather.cu``; declare the commit's C signature; check the struct's size."""
    from ..csrc.build import load

    lib = load("gather.cu")
    lib.commit_words_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.commit_words_launch.restype = ctypes.c_int
    lib.commit_args_size.argtypes = []
    lib.commit_args_size.restype = ctypes.c_int
    if lib.commit_args_size() != ctypes.sizeof(_CommitArgs):
        raise RuntimeError(f"commit_words: launch struct of {ctypes.sizeof(_CommitArgs)} bytes here, "
                           f"{lib.commit_args_size()} in csrc/gather.cu")
    return lib


def _scalar(name: str, x: Any, dev: torch.device) -> Tuple[Optional[ctypes.c_void_p], float]:
    """A parameter as the kernel reads it: a 0-d f32 device tensor by pointer (a captured
    graph reads its value at every replay), a Python number by value."""
    if isinstance(x, torch.Tensor):
        _check(name, x, torch.float32, (), dev)
        return _ptr(x), 0.0
    return None, float(x)


def commit_words(lms: List[Dict], prm: Dict, state: Dict, trie_rows: List[torch.Tensor],
                 use_hot: bool, collect_stats: bool) -> Dict:
    """Each beam's word-commit effects, one launch for every member, bit-exact.

    ``lms``: the members' device table dicts
    (:meth:`~pyctcdecode_torch.models.device_tables.DeviceLM.as_device`);
    ``prm``: the engine's unpacked parameters (``hot_weight`` and each
    member's ``alpha``, ``beta``, ``unk_offset``: Python numbers, or 0-d f32
    tensors on the device); ``state``: the beam state, of which it reads
    ``text_lo``, ``text_hi``, ``p_lo``, ``p_hi``, ``p_len`` int64 ``[N, B]``,
    ``fused`` f32 ``[N, B]``, per member ``p_flags{i}`` and ``ctx_len{i}``
    int64 ``[N, B]``, ``ctx{i}`` int64 and ``ctx_bo{i}`` f32 ``[N, B, w_i]``,
    and with ``use_hot`` ``h_bits`` int64 ``[N, B]``; ``trie_rows``: each
    member's fetched trie rows, int32 ``[N, B, W]`` (the last four words:
    the word's unigram prob and backoff bits, its order-1 flag, its word id).

    Returns ``text_lo``, ``text_hi``, ``word_fused`` and each member's
    ``ctx{i}``, ``ctx_len{i}``, ``ctx_bo{i}``, shaped as the state's, and
    with ``collect_stats`` ``probe_hits``: per member the bool ``[N, B]``
    full-suffix hit mask of each order 1 .. ``order``.

    Contract: word ids and context ids are in the members' vocabularies, as
    the engine's are by construction; the kernel does not check.
    """
    n, b = state["p_len"].shape
    dev = state["p_len"].device
    i64, f32 = torch.int64, torch.float32
    if len(trie_rows) != len(lms) or len(prm["lm"]) < len(lms):
        raise ValueError(f"commit_words: {len(lms)} members, {len(trie_rows)} trie row planes, "
                         f"{len(prm['lm'])} members' parameters")
    planes = [(key, state[key], i64, (n, b)) for key in ("text_lo", "text_hi", "p_lo", "p_hi", "p_len")]
    planes.append(("fused", state["fused"], f32, (n, b)))
    if use_hot:
        planes.append(("h_bits", state["h_bits"], i64, (n, b)))
    for i, lm in enumerate(lms):
        w = state[f"ctx{i}"].shape[-1]
        planes += [(f"p_flags{i}", state[f"p_flags{i}"], i64, (n, b)),
                   (f"ctx_len{i}", state[f"ctx_len{i}"], i64, (n, b)),
                   (f"ctx{i}", state[f"ctx{i}"], i64, (n, b, w)),
                   (f"ctx_bo{i}", state[f"ctx_bo{i}"], f32, (n, b, w)),
                   (f"trie_rows[{i}]", trie_rows[i], torch.int32, (n, b, trie_rows[i].shape[-1]))]
    for name, t, dtype, shape in planes:
        _check(name, t, dtype, shape, dev)
    if dev.type == "cpu":
        return commit_words_ref(lms, prm, state, trie_rows, use_hot, collect_stats)
    _launch_device(dev)
    if not commit_kernel_fits(lms):
        raise ValueError(
            f"commit_words: the kernel takes up to {MAX_MEMBERS} members of order >= 2 with whole "
            f"(unsharded) tables, {PROBE_MAX_TABLES} tables in all; run commit_words_ref"
        )
    out: Dict[str, Any] = {key: torch.empty_like(state[key]) for key in ("text_lo", "text_hi")}
    out["word_fused"] = torch.empty_like(state["fused"])
    hits = []
    for i, lm in enumerate(lms):
        for key in (f"ctx{i}", f"ctx_len{i}", f"ctx_bo{i}"):
            out[key] = torch.empty_like(state[key])
        if collect_stats:
            hits.append(torch.empty((lm["order"], n, b), dtype=torch.bool, device=dev))
    if collect_stats:
        out["probe_hits"] = [list(h.unbind(0)) for h in hits]
    if n * b == 0:
        return out

    args = _CommitArgs()
    t = 0
    for i, lm in enumerate(lms):
        w = state[f"ctx{i}"].shape[-1]
        if w != lm["order"] - 1 or len(lm["fp"]) != lm["order"] - 1:
            raise ValueError(f"lms[{i}]: order {lm['order']} with a context of {w} ids and "
                             f"{len(lm['fp'])} tables")
        _check(f"lms[{i}]['uni_unk_row']", lm["uni_unk_row"], f32, None, dev)
        m = args.m[i]
        key = m.key
        key.ctx, key.ctx_len, key.ctx_bo = (_ptr(state[f"{name}{i}"]) for name in ("ctx", "ctx_len", "ctx_bo"))
        key.p_flags, key.trie_row = _ptr(state[f"p_flags{i}"]), _ptr(trie_rows[i])
        key.unk_id, key.w, key.row_w = int(lm["unk_id"]), w, trie_rows[i].shape[-1]
        m.uni_unk_row = _ptr(lm["uni_unk_row"])
        for name in ("alpha", "beta", "unk_offset"):
            ptr, val = _scalar(f"prm['lm'][{i}]['{name}']", prm["lm"][i][name], dev)
            setattr(m, name, ptr)
            setattr(m, name + "_v", val)
        m.o_ctx, m.o_ctx_len, m.o_ctx_bo = (_ptr(out[f"{name}{i}"]) for name in ("ctx", "ctx_len", "ctx_bo"))
        if collect_stats:
            m.o_hits = _ptr(hits[i])
        m.unk_prob10, m.order, m.t0 = lm["unk_prob10"], lm["order"], t
        m.has_unigrams = int(bool(lm["has_unigrams"]))
        for j, tab in enumerate(lm["fp"]):
            _check(f"lms[{i}]['fp'][{j}]['bucket']", tab["bucket"], torch.int32, None, dev)
            if ((_BUCKET_SLOTS, _SUB_WIDTH, tab["bucket"].shape[1]) != PROBE_GEOMETRY or "row0" in tab
                    or tab["bucket"].shape[0] != tab["size"]):
                raise ValueError(f"lms[{i}]['fp'][{j}]: bucket {tuple(tab['bucket'].shape)} is not a whole "
                                 f"table of {tab['size']} rows of the probe's geometry {PROBE_GEOMETRY}")
            args.tabs.bucket[t] = tab["bucket"].data_ptr()
            args.tabs.size[t] = args.tabs.rows[t] = int(tab["size"])
            args.tabs.row0[t] = 0
            args.tabs.seed_lo[t], args.tabs.seed_hi[t] = int(tab["seed_lo"]) & M32, int(tab["seed_hi"]) & M32
            args.tabs.mode[t] = hash_mode_code(tab)
            args.keys[t] = key
            args.keys[t].n = j + 2
            t += 1
    for name in ("text_lo", "text_hi", "p_lo", "p_hi", "p_len"):
        setattr(args, name, _ptr(state[name]))
    if use_hot:
        args.h_bits = _ptr(state["h_bits"])
        args.hot_weight, args.hot_weight_v = _scalar("prm['hot_weight']", prm["hot_weight"], dev)
    args.o_text_lo, args.o_text_hi, args.o_word_fused = (_ptr(out[k]) for k in ("text_lo", "text_hi", "word_fused"))
    args.bit_in_vocab, args.bit_uni_word, args.hot_word_bit = _BIT_IN_VOCAB, _BIT_UNI_WORD, HOT_WORD_BIT
    args.ln10, args.nb = _LOG10, n * b
    args.n_lms, args.n_tables, args.stats = len(lms), t, int(bool(collect_stats))
    _launch("commit_words", dev, _library().commit_words_launch, ctypes.byref(args))
    commit_words.launches += 1
    return out


commit_words.launches = 0
