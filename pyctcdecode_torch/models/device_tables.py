"""Device-resident LM tables: fingerprint probe tables and a packed vocab trie.

The reference scores beams through per-word C++ callbacks into KenLM
(ref ``language_model.py:306-360``); a GPU step cannot call back to the
host per word, so this module compiles the same model into flat arrays
probed on the device:

* **n-gram tables** — one bucketized hash table per order n >= 2: two
  16-slot sub-blocks per bucket, a bucket row packed as 128 i32 words
  (struct-of-arrays per sub-block: 16x fp_lo, 16x fp_hi, 16x prob, 16x
  backoff). A probe reads ONE 512-byte row and compares fingerprints in
  registers. Keys are matched by 64-bit fingerprint (KenLM's probing format
  accepts the same hashed-key risk); build-time reseeding keeps residents
  of every bucket fingerprint-distinct, so every key that IS in the table
  always resolves to its own value.
* **unigrams** — a dense ``[vocab, 4]`` array indexed by word id directly.
* **hotword trie** — per decode call, the hotword unigrams as a small
  packed trie (:func:`build_hotword_tables`), walked by plain indexing.
* **vocab trie** — a packed character trie over the LM vocabulary plus the
  known-unigram set. Beams carry their in-progress word as a trie node id;
  one row read per consumed character advances it. Node flags answer every
  string question the decoder asks: "is this partial a prefix of a known
  unigram" (ref ``language_model.py:326-336``), "what is this completed
  word's LM id", "is it in the unigram set / the LM vocab" (OOV rule, ref
  ``language_model.py:349-353``).

The numpy builders are bit-equal copies of the JAX reference package's, but
for labels that spell the LM's ``<s>`` / ``</s>`` (:func:`build_vocab_trie`
keeps them as words there, as the host engine scores them); the probe
functions are their torch counterparts. Geometry is read from
``_BUCKET_SLOTS`` / ``_SUB_WIDTH`` and :func:`trie_pack_params`, never
assumed.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Collection, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.gather import HASH_MODES, bucket_readout, gather_rows, probe_rows, query_hashes
from ..ops.hashing import KENLM_BASE_SEED as _KENLM_BASE_SEED
from ..ops.hashing import fnv1a, fnv1a_seeded, kenlm_chain, mix32_pair
from ..ops.tokens import TokenArrays
from ..utils import profiling
from .kenlm_bin import KenLMBinaryModel
from .language_model import LanguageModel
from .ngram import BOS_WORD, EOS_WORD, NGramModel, NGramTables

_MIN_TABLE = 8

# packed hotword-trie entry layout: child node (20 bits), shortest-completion
# length (10 bits, saturating), is-hotword-terminal (bit 30)
HOT_NODE_MASK = (1 << 20) - 1
HOT_MINCOMP_SHIFT = 20
HOT_MINCOMP_MAX = 1023
HOT_WORD_BIT = 1 << 30


# --------------------------------------------------------------------------
# n-gram fingerprint tables (orders >= 2) + dense unigram array
# --------------------------------------------------------------------------
_FP_EMPTY = np.uint32(0xFFFFFFFF)  # fp_lo sentinel marking an empty slot
_FP_SEED_LO = 0x811C9DC5 ^ 0x5BD1E995
_FP_SEED_HI = 0x811C9DC5 ^ 0xC2B2AE35


# Bucket geometry (the layout the JAX reference builds, kept bit-equal): a
# bucket row is ``_SUB_BUCKETS`` independent 16-slot sub-blocks, each laid
# out [lo x16 | hi x16 | prob x16 | backoff x16], so one 512-byte row read
# serves a 32-resident bucket. Fingerprints are pairwise distinct across
# the WHOLE row by construction, so the masked readout sums touch at most
# one slot.
_BUCKET_SLOTS = 16  # slots per sub-block = readout compare lanes
_SUB_BUCKETS = 2
_BUCKET_CAP = _BUCKET_SLOTS * _SUB_BUCKETS  # residents per gathered row
_SUB_WIDTH = 4 * _BUCKET_SLOTS
_BUCKET_WIDTH = _SUB_WIDTH * _SUB_BUCKETS


@dataclasses.dataclass(frozen=True)
class LMShard:
    """This process's share of a row-sharded LM: rank ``rank`` of the ``size`` processes of ``group``.

    Each process holds rows ``[rank * rows, (rank + 1) * rows)`` of every
    n-gram bucket plane (``rows = shard_rows(size of the plane, size)``);
    the trie, the unigrams and everything else are replicated. ``group`` is
    a ``torch.distributed`` process group.
    """

    group: Any
    rank: int
    size: int


def shard_rows(size: int, n_shards: int) -> int:
    """Rows of one shard of a bucket plane of ``size`` rows (ceil split)."""
    return -(-size // n_shards)


def shard_bucket_plane(bucket: np.ndarray, n_shards: int) -> np.ndarray:
    """A bucket plane ``[size, W]`` cut into ``[n_shards, shard_rows, W]`` row blocks.

    A size that does not divide pads with rows that no query's base slot
    reaches (the base slot stays ``< size``), their fingerprint lanes the
    empty sentinel, as the JAX reference's ``build_table_args(shard=...)``.
    """
    size, width = bucket.shape
    rows = shard_rows(size, n_shards)
    pad = n_shards * rows - size
    plane = bucket
    if pad:
        empty = np.zeros((pad, width), dtype=np.uint32)
        mark_empty_fp_rows(empty)
        plane = np.concatenate([bucket, empty.view(np.int32)], axis=0)
    return plane.reshape(n_shards, rows, width)


def mark_empty_fp_rows(rows_u32: np.ndarray) -> None:
    """Set every sub-block's fp_lo lanes to the empty sentinel, in place.

    Zero-filled rows are NOT safe vacancies — 0 is a valid fingerprint
    lane value — so padding/vacant rows must carry the sentinel in each
    sub-block's lo field (the hi/prob/backoff fields can stay zero).
    """
    for sub in range(_SUB_BUCKETS):
        rows_u32[:, sub * _SUB_WIDTH : sub * _SUB_WIDTH + _BUCKET_SLOTS] = _FP_EMPTY



@dataclasses.dataclass
class FPTable:
    """One order's probe table in the single-gather bucket layout.

    Entries live in the bucket their base hash selects — never elsewhere —
    so a probe is: gather ``bucket[h % size]`` (one row of
    ``_BUCKET_WIDTH`` words), compare the query's 64-bit fingerprint
    against all resident fingerprints in-register, and read the matching
    slot's (prob, backoff). The build grows ``size`` until every bucket fits and
    reseeds the fingerprint lanes until residents of every bucket are
    pairwise distinct, so present keys always resolve exactly.
    """

    n: int  # key width (the order)
    size: int  # bucket count (2^k or 3*2^k rung)
    seed_lo: int  # fingerprint lane seeds (reseeded on build-time collision)
    seed_hi: int
    count: int
    # i32 [size, _BUCKET_WIDTH], struct-of-arrays columns in slot-count
    # strides: fp_lo (u32 bits, _FP_EMPTY = vacant), fp_hi, prob (f32
    # bits), backoff (f32 bits)
    bucket: np.ndarray
    # "fnv": keys are id tuples hashed with seeded FNV lanes (ARPA and
    # .ctclm models); "kenlm64": keys are KenLM 64-bit chain hashes (KenLM
    # binaries), see build_fp_table_from_hashes
    hash_mode: str = "fnv"


def _fp_lanes(keys: np.ndarray, seed_lo: int, seed_hi: int):
    """64-bit fingerprint as two u32 lanes (both reserve the empty sentinel)."""
    lo = fnv1a_seeded(np, keys, np.uint32(seed_lo))
    hi = fnv1a_seeded(np, keys, np.uint32(seed_hi))
    lo = np.minimum(lo, _FP_EMPTY - np.uint32(1))
    hi = np.minimum(hi, _FP_EMPTY - np.uint32(1))
    return lo, hi


def _assemble_fp(
    base_full: np.ndarray,
    lane_fn: "object",
    probs: np.ndarray,
    backoffs: np.ndarray,
    n: int,
    hash_mode: str,
) -> FPTable:
    """Place entries into ``_BUCKET_SLOTS``-slot buckets; pack the plane.

    Bucketized placement (no probing across buckets): entry *e* lives in
    bucket ``base_full[e] % size``, at any free slot. The bucket
    count doubles until the fullest bucket fits (Poisson tails make this
    terminate near load factor ~1/3), then the
    fingerprint lanes (``lane_fn(seed_lo, seed_hi)``) reseed until no two
    residents of a bucket share a full 64-bit fingerprint — lookups of
    present keys are then exact, and the masked-sum readout touches at
    most one slot.
    """
    count = len(base_full)
    probs = np.asarray(probs, dtype=np.float32)
    backoffs = np.asarray(backoffs, dtype=np.float32)
    # size ladder {2^k, 3*2^k}: pure power-of-two growth overshoots the
    # max-bucket Poisson tail by a whole doubling; the x1.5 rung absorbs
    # it with less memory. Bucket index is ``hash % size``.
    def _next_size(cur: int) -> int:
        return cur * 3 // 2 if (cur & (cur - 1)) == 0 else cur * 4 // 3

    size = _MIN_TABLE
    while size * (3 * _BUCKET_CAP // 8) < count:  # ~load factor 1/3
        size = _next_size(size)
    while True:
        base = (base_full % np.uint32(size)).astype(np.int64)
        if count:
            counts = np.bincount(base, minlength=size)
            if int(counts.max()) > _BUCKET_CAP:
                size = _next_size(size)
                continue
        break
    order_idx = np.argsort(base, kind="stable")
    sb = base[order_idx]
    # slot within bucket = rank among same-bucket entries (sb is sorted)
    pos = np.arange(count, dtype=np.int64) - np.searchsorted(sb, sb, side="left")
    seed_lo, seed_hi = _FP_SEED_LO, _FP_SEED_HI
    for _attempt in range(256):
        lo, hi = lane_fn(seed_lo, seed_hi)
        lo, hi = lo[order_idx], hi[order_idx]
        same_bucket = sb[1:] == sb[:-1]
        dup = same_bucket & (lo[1:] == lo[:-1]) & (hi[1:] == hi[:-1])
        # sorted-by-bucket order is not sorted by fp, so compare all pairs
        # within each bucket the cheap way: sort (bucket, lo, hi) rows
        if count and bool(np.any(dup)):
            collision = True
        elif count:
            key_order = np.lexsort((hi, lo, sb))
            sb2, lo2, hi2 = sb[key_order], lo[key_order], hi[key_order]
            collision = bool(
                np.any(
                    (sb2[1:] == sb2[:-1])
                    & (lo2[1:] == lo2[:-1])
                    & (hi2[1:] == hi2[:-1])
                )
            )
        else:
            collision = False
        if not collision:
            break
        seed_lo = (seed_lo + 0x9E3779B9) & 0xFFFFFFFF
        seed_hi = (seed_hi + 0x85EBCA6B) & 0xFFFFFFFF
    else:
        raise ValueError(
            "could not find collision-free fingerprint seeds in 256 "
            "attempts — the key set contains entries whose fingerprint "
            "inputs are identical (duplicate keys?)"
        )
    bucket = np.zeros((size, _BUCKET_WIDTH), dtype=np.uint32)
    mark_empty_fp_rows(bucket)
    if count:
        # resident ``pos`` (0.._BUCKET_CAP-1) fills sub-block 0 first
        col = (pos // _BUCKET_SLOTS) * _SUB_WIDTH + pos % _BUCKET_SLOTS
        bucket[sb, col] = lo
        bucket[sb, _BUCKET_SLOTS + col] = hi
        bucket[sb, 2 * _BUCKET_SLOTS + col] = probs[order_idx].view(np.uint32)
        bucket[sb, 3 * _BUCKET_SLOTS + col] = backoffs[order_idx].view(np.uint32)
    return FPTable(
        n=n,
        size=size,
        seed_lo=seed_lo,
        seed_hi=seed_hi,
        count=count,
        bucket=bucket.view(np.int32),
        hash_mode=hash_mode,
    )


def build_fp_table(
    keys: np.ndarray, probs: np.ndarray, backoffs: np.ndarray
) -> FPTable:
    """Build one order's table from id-tuple keys (FNV base + lanes)."""
    keys = np.asarray(keys, dtype=np.int32)
    count, n = keys.shape if keys.ndim == 2 else (0, 1)
    keys = keys.reshape(count, n)
    base_full = fnv1a(np, keys) if count else np.empty(0, dtype=np.uint32)
    return _assemble_fp(
        base_full,
        lambda sl, sh: _fp_lanes(keys, sl, sh),
        probs,
        backoffs,
        n,
        "fnv",
    )


def build_fp_table_from_hashes(
    keys64: np.ndarray, probs: np.ndarray, backoffs: np.ndarray, n: int
) -> FPTable:
    """Build one order's table straight from KenLM 64-bit chain hashes.

    A KenLM PROBING binary never stores the n-gram tuples, so the usual
    id-tuple build is impossible — but its chain hash is itself a 64-bit
    fingerprint the device can recompute from query ids
    (:func:`~pyctcdecode_torch.ops.hashing.kenlm_chain`). The base slot is
    the JAX reference's, a seeded mix of both halves of the hash. Each
    fingerprint lane is a seeded murmur3 finalizer of ONE half (a bijection
    of it), so two distinct keys always differ in a lane and the table
    matches on all 64 bits, as kenlm's own probing lookup does.

    This departs from the JAX reference (``hash_mode="kenlm"``), whose two
    lanes mix both halves through ``lo ^ hi * 0x85EBCA6B`` alone: base and
    lanes then depend on one 32-bit value, keys that share it can never be
    told apart by any reseed, and at a LibriSpeech-scale table (1.1-1.5M
    n-grams per order, ~150-260 keys sharing it) its build gives up; a query
    that shares it with a resident would read that resident. Tables built
    that way are refused by :meth:`DeviceLM.from_numpy`.
    """
    keys64 = np.asarray(keys64, dtype=np.uint64)
    # duplicate chain hashes (authentic probing binaries can contain
    # colliding keys; kenlm's lookup resolves to one of them) would make
    # the fingerprint reseed loop spin forever — keep the first
    # occurrence, matching probing-lookup semantics
    _, first_idx = np.unique(keys64, return_index=True)
    if len(first_idx) != len(keys64):
        keep = np.sort(first_idx)
        keys64 = keys64[keep]
        probs = np.asarray(probs)[keep]
        backoffs = np.asarray(backoffs)[keep]
    lo32 = (keys64 & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi32 = (keys64 >> np.uint64(32)).astype(np.uint32)
    base_full = mix32_pair(np, lo32, hi32, np.uint32(_KENLM_BASE_SEED))

    zero = np.uint32(0)

    def lanes(seed_lo, seed_hi):
        lo = mix32_pair(np, lo32, zero, np.uint32(seed_lo))
        hi = mix32_pair(np, hi32, zero, np.uint32(seed_hi))
        return (
            np.minimum(lo, _FP_EMPTY - np.uint32(1)),
            np.minimum(hi, _FP_EMPTY - np.uint32(1)),
        )

    return _assemble_fp(base_full, lanes, probs, backoffs, n, "kenlm64")


def _query_hashes(tab: Dict, query: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Base hash + clamped fingerprint lanes for a query batch ``[Q, n]`` (numpy).

    Mode "fnv" hashes the id tuple directly; mode "kenlm64" first folds the
    ids through KenLM's 64-bit chain (the only key a PROBING binary
    stores), then mixes both halves into the base hash and each half into
    its lane (:func:`build_fp_table_from_hashes`).
    """
    if tab.get("hash_mode", "fnv") == "kenlm64":
        klo, khi = kenlm_chain(np, query)
        h = mix32_pair(np, klo, khi, np.uint32(_KENLM_BASE_SEED))
        lo = mix32_pair(np, klo, np.uint32(0), tab["seed_lo"])
        hi = mix32_pair(np, khi, np.uint32(0), tab["seed_hi"])
    else:
        h = fnv1a(np, query)
        lo = fnv1a_seeded(np, query, tab["seed_lo"])
        hi = fnv1a_seeded(np, query, tab["seed_hi"])
    lo = np.minimum(lo, np.uint32(0xFFFFFFFE))
    hi = np.minimum(hi, np.uint32(0xFFFFFFFE))
    return h, lo, hi


def probe_fp_host(table: FPTable, keys: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized numpy mirror of the device probe (build/host-state path)."""
    keys = np.asarray(keys, dtype=np.int32).reshape(-1, table.n)
    nq = keys.shape[0]
    h, lo, hi = _query_hashes(
        {
            "hash_mode": table.hash_mode,
            "seed_lo": np.uint32(table.seed_lo),
            "seed_hi": np.uint32(table.seed_hi),
        },
        keys,
    )
    base = (h % np.uint32(table.size)).astype(np.int64)
    all_rows = table.bucket.view(np.uint32)[base]  # [Q, _BUCKET_WIDTH]
    s_ = _BUCKET_SLOTS
    found = np.zeros(nq, dtype=bool)
    prob = np.zeros(nq, dtype=np.uint32)
    backoff = np.zeros(nq, dtype=np.uint32)
    for sub in range(all_rows.shape[1] // _SUB_WIDTH):
        rows = all_rows[:, sub * _SUB_WIDTH : (sub + 1) * _SUB_WIDTH]
        eq = (rows[:, :s_] == lo[:, None]) & (
            rows[:, s_ : 2 * s_] == hi[:, None]
        )
        found |= eq.any(axis=1)
        prob += np.where(eq, rows[:, 2 * s_ : 3 * s_], 0).sum(
            axis=1, dtype=np.uint64
        ).astype(np.uint32)
        backoff += np.where(eq, rows[:, 3 * s_ :], 0).sum(
            axis=1, dtype=np.uint64
        ).astype(np.uint32)
    prob = np.where(found, prob, np.uint32(0)).view(np.float32)
    backoff = np.where(found, backoff, np.uint32(0)).view(np.float32)
    return found, prob.astype(np.float32), backoff.astype(np.float32)


def build_unigram_array(
    entries: Dict[Tuple[int, ...], Tuple[np.float32, np.float32]], n_vocab: int
) -> np.ndarray:
    """Dense ``[vocab, 4]`` f32 rows: (prob, backoff, exists, 0) by word id."""
    uni = np.zeros((max(n_vocab, 1), 4), dtype=np.float32)
    for (wid,), (p_val, b_val) in entries.items():
        if 0 <= wid < n_vocab:
            uni[wid, 0] = p_val
            uni[wid, 1] = b_val
            uni[wid, 2] = 1.0
    return uni


def context_suffix_backoffs(dlm: "DeviceLM", ctx: "object") -> np.ndarray:
    """Backoff weights of every suffix of ``ctx`` (right-aligned, 0 absent)."""
    width = max(dlm.order - 1, 1)
    out = np.zeros(width, dtype=np.float32)
    ctx = tuple(int(w) for w in ctx)
    for j in range(1, len(ctx) + 1):
        suffix = ctx[len(ctx) - j :]
        if j == 1:
            wid = suffix[0]
            if 0 <= wid < dlm.uni.shape[0] and dlm.uni[wid, 2] > 0.5:
                out[width - 1] = dlm.uni[wid, 1]
        else:
            found, _, bo = probe_fp_host(
                dlm.fp_tables[j - 2], np.asarray(suffix, dtype=np.int32)
            )
            if bool(found[0]):
                out[width - j] = float(bo[0])
    return out


# --------------------------------------------------------------------------
# packed char trie
# --------------------------------------------------------------------------
@dataclasses.dataclass
class PackedTrie:
    """Char trie as flat arrays. Node 0 = root; node ``dead`` swallows."""

    next: np.ndarray  # int32 [N, n_chars]
    word_id: np.ndarray  # int32 [N] (-1: not a vocab word terminal)
    is_uni_word: np.ndarray  # bool [N] (terminal of a known-unigram)
    is_uni_prefix: np.ndarray  # bool [N] (prefix of a known-unigram)
    min_completion: np.ndarray  # int32 [N] shortest key length through node
    dead: int

    @property
    def n_nodes(self) -> int:
        return int(self.next.shape[0])


class _TrieBuilder:
    def __init__(self, n_chars: int) -> None:
        self.n_chars = n_chars
        self.next: List[np.ndarray] = [np.full(n_chars, -1, dtype=np.int64)]
        self.word_id: List[int] = [-1]
        self.is_uni_word: List[bool] = [False]
        self.is_uni_prefix: List[bool] = [False]
        self.min_completion: List[int] = [0]

    def insert(self, key_ids: List[int], depth_len: int) -> int:
        """Insert a key path; returns its terminal node id."""
        node = 0
        if self.min_completion[0] == 0 or depth_len < self.min_completion[0]:
            self.min_completion[0] = depth_len
        for cid in key_ids:
            nxt = self.next[node][cid]
            if nxt < 0:
                nxt = len(self.next)
                self.next[node][cid] = nxt
                self.next.append(np.full(self.n_chars, -1, dtype=np.int64))
                self.word_id.append(-1)
                self.is_uni_word.append(False)
                self.is_uni_prefix.append(False)
                self.min_completion.append(depth_len)
            elif depth_len < self.min_completion[nxt]:
                self.min_completion[nxt] = depth_len
            node = int(nxt)
        return node

    def pack(self) -> PackedTrie:
        """Freeze the builder into flat arrays (adds the dead node).

        Nodes are renumbered breadth-first (shallow levels get the lowest
        ids): beams overwhelmingly sit on short partial words, so the hot
        rows of the device trie plane concentrate in its first few MB
        instead of scattering across hundreds (insertion order is
        per-word DFS). BFS order also makes each node's children
        contiguous ids, which the packed plane relies on.
        """
        n = len(self.next)
        dead = n
        table = np.stack(self.next) if n else np.zeros((0, self.n_chars), np.int64)

        # BFS order: every node has exactly one parent in a trie, so the
        # frontier expansion needs no dedup; child order within a level is
        # (parent order, char order) — deterministic.
        new_of_old = np.full(n, -1, dtype=np.int64)
        if n:
            frontier = np.array([0], dtype=np.int64)
            new_of_old[0] = 0
            assigned = 1
            while frontier.size:
                kids = table[frontier].reshape(-1)
                kids = kids[kids >= 0]
                new_of_old[kids] = assigned + np.arange(kids.size)
                assigned += kids.size
                frontier = kids

        perm = np.argsort(new_of_old)  # old id at each new position
        old_next = np.where(table >= 0, table, dead)
        remap = np.append(new_of_old, dead)  # dead stays the last id
        nxt = np.full((n + 1, self.n_chars), dead, dtype=np.int32)
        if n:
            nxt[:n] = remap[old_next[perm]].astype(np.int32)
        word_id = np.array(self.word_id, np.int32)[perm] if n else np.zeros(0, np.int32)
        uni_word = np.array(self.is_uni_word, bool)[perm] if n else np.zeros(0, bool)
        uni_prefix = (
            np.array(self.is_uni_prefix, bool)[perm] if n else np.zeros(0, bool)
        )
        min_comp = (
            np.array(self.min_completion, np.int32)[perm]
            if n
            else np.zeros(0, np.int32)
        )
        return PackedTrie(
            next=nxt,
            word_id=np.append(word_id, -1),
            is_uni_word=np.append(uni_word, False),
            is_uni_prefix=np.append(uni_prefix, False),
            min_completion=np.append(min_comp, 0),
            dead=dead,
        )


def build_vocab_trie(
    vocab: Dict[str, int],
    unigram_set: "object",
    char2id: Dict[str, int],
    unk_id: int,
    label_chars: Collection[str],
) -> PackedTrie:
    """Trie over LM vocab words (carrying word ids) and known unigrams.

    The LM's sentence markers ``<s>`` and ``</s>`` are words like any other
    where the labels can spell them (every char of theirs in
    ``label_chars``, as with wav2vec2's ``<s>`` / ``</s>`` labels): the host
    engine scores a decoded marker as the LM's word, and so does the device.
    Where the labels cannot, they stay out, and the trie is the one the JAX
    package's device engine builds.
    """
    builder = _TrieBuilder(len(char2id))
    label_chars = set(label_chars)

    def _ids(word: str) -> Optional[List[int]]:
        out = []
        for ch in word:
            cid = char2id.get(ch)
            if cid is None:
                return None  # contains a char no decodable string can produce
            out.append(cid)
        return out

    markers = 0
    for word, wid in vocab.items():
        if wid == unk_id:
            continue
        if word in (BOS_WORD, EOS_WORD):
            if not set(word) <= label_chars:
                continue
            markers += 1
        ids = _ids(word)
        if ids is None:
            continue
        node = builder.insert(ids, len(word))
        builder.word_id[node] = wid
    for word in unigram_set:
        ids = _ids(word)
        if ids is None:
            continue
        node = builder.insert(ids, len(word))
        builder.is_uni_word[node] = True
        # mark the whole path as a unigram prefix
        cur = 0
        builder.is_uni_prefix[0] = True
        for cid in ids:
            cur = int(builder.next[cur][cid])
            builder.is_uni_prefix[cur] = True
    profiling.count("build.sentence_words", markers)
    return builder.pack()


_TRIE_ROW_WORDS = 64  # target plane-row width (nodes folded per gather row)


def trie_pack_params(n_chars: int) -> Dict[str, int]:
    """Static cell-packing geometry of the trie plane (see _pack_trie_plane).

    BFS numbering makes every node's children CONTIGUOUS ids ordered by
    char, so a child pointer compresses from a 32-bit absolute id to its
    RANK among the node's children (``rb`` bits, all-ones = no child)
    plus the child's 3 flag bits — one small cell per char instead of a
    full i32 entry. The node's slot stores one ``first_child`` word plus
    ``ncw`` packed cell words (+ 4 unigram/word-id words). For a ~28-char
    alphabet a node's entry is 13 words; ``pack`` node slots of ``stride``
    words fold into one plane row of ``_TRIE_ROW_WORDS`` i32 words (256
    bytes). The unpack is elementwise integer work on the fetched row.
    """
    rb = 1
    while (1 << rb) - 1 < max(n_chars, 1):
        rb += 1  # sentinel (all-ones) must exceed every rank (< n_chars)
    bpc = rb + 3  # rank bits + 3 child flag bits
    cpw = max(32 // bpc, 1)
    ncw = -(-max(n_chars, 1) // cpw)
    w = 1 + ncw + 4
    # Multiple nodes share one plane row (node's slot at ``stride``-word
    # alignment, ``pack`` per row); the walk fetches row ``node // pack``
    # and takes slot ``node % pack`` out of it.
    stride = -(-w // 8) * 8
    pack = max(1, _TRIE_ROW_WORDS // stride)
    return {
        "rb": rb, "cpw": cpw, "ncw": ncw, "width": w,
        "stride": stride, "pack": pack,
    }


def _pack_trie_plane(
    trie: PackedTrie, flag3: np.ndarray, uni: np.ndarray
) -> np.ndarray:
    """Build the cell-packed trie plane (see :func:`trie_pack_params`).

    Row layout (width ``1 + ncw + 4`` i32 words):

    * col 0: ``first_child`` — the node's smallest child id (0 if none);
      child at rank r has id ``first_child + r`` (BFS contiguity,
      asserted below);
    * cols 1..ncw: packed cells, ``cpw`` chars per word, char ``c`` in
      word ``c // cpw`` at bit ``(c % cpw) * bpc``; a cell is
      ``rank | (child_flag3 << rb)`` or all-ones when no child;
    * col W-4: the node's word unigram log10-prob (f32 bits),
    * col W-3: its unigram backoff (f32 bits),
    * col W-2: unigram-exists flag,
    * col W-1: the vocab word id (-1 for non-terminal nodes).

    ``flag3`` is the per-node 3-bit flag vector (bit0 IN_VOCAB, bit1
    UNI_WORD, bit2 UNI_PREFIX — the low bits of the packed-entry flag
    nibble, shifted to ``DeviceLM.BIT_*`` positions by the device walk).
    """
    prm = trie_pack_params(trie.next.shape[1])
    rb, cpw, ncw, w = prm["rb"], prm["cpw"], prm["ncw"], prm["width"]
    bpc = rb + 3
    sentinel = np.uint32((1 << bpc) - 1)  # rank all-ones, flags all-ones
    nxt = trie.next  # [N, C], missing children stored as the dead id
    n, c = nxt.shape
    has = nxt != trie.dead
    rank = np.cumsum(has, axis=1, dtype=np.int64) - has
    fc = np.where(
        has.any(axis=1),
        np.min(np.where(has, nxt, np.iinfo(np.int32).max), axis=1),
        0,
    ).astype(np.int64)
    # BFS contiguity is the layout's correctness contract — verify it
    if not bool(
        np.array_equal(np.where(has, nxt, 0), np.where(has, fc[:, None] + rank, 0))
    ):  # pragma: no cover - BFS numbering guarantees this
        raise AssertionError("trie children are not BFS-contiguous")
    cell = np.where(
        has, rank.astype(np.uint32) | (flag3[nxt].astype(np.uint32) << rb), sentinel
    ).astype(np.uint32)
    cells = np.full((n, ncw * cpw), sentinel, dtype=np.uint32)
    cells[:, :c] = cell
    words = np.zeros((n, ncw), dtype=np.uint32)
    for j in range(cpw):
        words |= cells[:, j::cpw] << np.uint32(j * bpc)
    rows = np.zeros((n, w), dtype=np.int32)
    rows[:, 0] = fc.astype(np.int32)
    rows[:, 1 : 1 + ncw] = words.view(np.int32)
    word_id = trie.word_id
    has_w = word_id >= 0
    wid_safe = np.where(has_w, word_id, 0)
    rows[:, w - 4] = np.where(has_w, uni[wid_safe, 0].view(np.int32), 0)
    rows[:, w - 3] = np.where(has_w, uni[wid_safe, 1].view(np.int32), 0)
    rows[:, w - 2] = np.where(has_w, uni[wid_safe, 2] > 0.5, False).astype(np.int32)
    rows[:, w - 1] = word_id
    # fold ``pack`` consecutive nodes into each 256-B plane row (slots at
    # ``stride``-word alignment); trailing pad slots are unreachable —
    # node ids stay < n, so no gather ever selects them
    stride, pack = prm["stride"], prm["pack"]
    n_rows = -(-n // pack)
    plane = np.zeros((n_rows * pack, stride), dtype=np.int32)
    plane[:n, :w] = rows
    return plane.reshape(n_rows, pack * stride)


def trie_seed_nodes(trie: PackedTrie, tokens: TokenArrays) -> np.ndarray:
    """Node reached from the root by each token's piece (boundary seeding)."""
    v = tokens.vocab_size
    seeds = np.zeros(v, dtype=np.int32)
    for t in range(v):
        node = 0
        for j in range(int(tokens.piece_len[t])):
            cid = int(tokens.piece_chars[t, j])
            node = int(trie.next[node, cid])
        seeds[t] = node
    return seeds


# --------------------------------------------------------------------------
# bundle
# --------------------------------------------------------------------------
@dataclasses.dataclass
class DeviceLM:
    """Everything the device step needs to score a shallow-fusion n-gram LM."""

    order: int
    unk_id: int
    eos_id: int
    unk_prob10: float  # unigram log10 prob of <unk> (ill-formed-table fallback)
    start_ctx: np.ndarray  # int32 [order-1], right-aligned, -1 pad (<s> state)
    start_ctx_len: int
    start_ctx_backoffs: np.ndarray  # f32 [order-1], suffix backoffs of start_ctx
    uni: np.ndarray  # f32 [vocab, 4]: (prob, backoff, exists, 0) by word id
    fp_tables: List[FPTable]  # orders 2..order, bucketized layout
    trie: PackedTrie
    seed_node: np.ndarray  # int32 [V]
    has_unigrams: bool

    # bit layout of packed trie transition entries: the child node id in the
    # low 28 bits plus the child's flags, so one row read of a walk also
    # yields everything the scorer asks about the new partial word
    NODE_MASK = (1 << 28) - 1
    BIT_IN_VOCAB = 1 << 28
    BIT_UNI_WORD = 1 << 29
    BIT_UNI_PREFIX = 1 << 30

    @classmethod
    def from_numpy(
        cls,
        *,
        order: int,
        unk_id: int,
        eos_id: int,
        unk_prob10: float,
        start_ctx: np.ndarray,
        start_ctx_len: int,
        start_ctx_backoffs: np.ndarray,
        uni: np.ndarray,
        fp_tables: Sequence[Dict[str, Any]],
        trie: Dict[str, Any],
        seed_node: np.ndarray,
        has_unigrams: bool,
    ) -> "DeviceLM":
        """Tables built elsewhere (e.g. by the JAX reference package), as numpy.

        ``fp_tables`` holds one dict per order with ``bucket``, ``size``,
        ``seed_lo``, ``seed_hi``, ``n``, ``hash_mode`` (and optionally
        ``count``); ``trie`` holds :class:`PackedTrie`'s fields. The JAX
        package's KenLM-keyed tables (``hash_mode="kenlm"``) are refused:
        see :func:`build_fp_table_from_hashes`.
        """
        tables = []
        for t in fp_tables:
            hash_mode = t.get("hash_mode", "fnv")
            if hash_mode == "kenlm":
                raise ValueError(
                    "hash_mode 'kenlm' tables (the JAX reference package's KenLM-keyed "
                    "tables) fingerprint a 32-bit fold of the 64-bit chain, so distinct "
                    "n-grams can share every lane; build the tables from the binary "
                    "instead (build_device_lm, hash_mode 'kenlm64')"
                )
            if hash_mode not in HASH_MODES:
                raise ValueError(f"unknown hash_mode {hash_mode!r}; expected one of {HASH_MODES}")
            tables.append(
                FPTable(
                    n=int(t["n"]),
                    size=int(t["size"]),
                    seed_lo=int(t["seed_lo"]),
                    seed_hi=int(t["seed_hi"]),
                    count=int(t.get("count", 0)),
                    bucket=np.asarray(t["bucket"], dtype=np.int32),
                    hash_mode=hash_mode,
                )
            )
        return cls(
            order=int(order),
            unk_id=int(unk_id),
            eos_id=int(eos_id),
            unk_prob10=float(unk_prob10),
            start_ctx=np.asarray(start_ctx, dtype=np.int32),
            start_ctx_len=int(start_ctx_len),
            start_ctx_backoffs=np.asarray(start_ctx_backoffs, dtype=np.float32),
            uni=np.asarray(uni, dtype=np.float32),
            fp_tables=tables,
            trie=PackedTrie(
                next=np.asarray(trie["next"], dtype=np.int32),
                word_id=np.asarray(trie["word_id"], dtype=np.int32),
                is_uni_word=np.asarray(trie["is_uni_word"], dtype=bool),
                is_uni_prefix=np.asarray(trie["is_uni_prefix"], dtype=bool),
                min_completion=np.asarray(trie["min_completion"], dtype=np.int32),
                dead=int(trie["dead"]),
            ),
            seed_node=np.asarray(seed_node, dtype=np.int32),
            has_unigrams=bool(has_unigrams),
        )

    def _node_flag_bits(self, nodes: np.ndarray) -> np.ndarray:
        bits = np.zeros(nodes.shape, dtype=np.int64)
        bits |= np.where(self.trie.word_id[nodes] >= 0, self.BIT_IN_VOCAB, 0)
        bits |= np.where(self.trie.is_uni_word[nodes], self.BIT_UNI_WORD, 0)
        bits |= np.where(self.trie.is_uni_prefix[nodes], self.BIT_UNI_PREFIX, 0)
        return bits

    def _node_flag3(self) -> np.ndarray:
        """Per-node 3-bit flags (low-bit form packed into trie-plane cells)."""
        f = (self.trie.word_id >= 0).astype(np.uint32)
        f |= self.trie.is_uni_word.astype(np.uint32) << 1
        f |= self.trie.is_uni_prefix.astype(np.uint32) << 2
        return f

    @property
    def trie_pack(self) -> Dict[str, int]:
        """Static packing geometry of the trie plane (+ the dead node id)."""
        prm = dict(trie_pack_params(self.trie.next.shape[1]))
        prm["dead"] = self.trie.dead
        return prm

    def trie_plane(self) -> np.ndarray:
        """The packed trie plane ``[rows, pack * stride]`` i32 (numpy)."""
        return _pack_trie_plane(self.trie, self._node_flag3(), self.uni)

    def seed_entries(self) -> np.ndarray:
        """Packed (node | flag bits) entry each token's piece seeds, int32 [V]."""
        return (
            self.seed_node.astype(np.int64) | self._node_flag_bits(self.seed_node)
        ).astype(np.int32)

    def as_device(self, device: "torch.device | str", shard: Optional[LMShard] = None) -> Dict[str, Any]:
        """Upload every plane to ``device`` as contiguous tensors (call once).

        Returns the table dict the probe functions and the engine read:
        tensors plus the Python-int scalars (seeds, sizes, ids) and the
        trie geometry. With ``shard``, each n-gram table holds only this
        process's row block of its bucket plane (:func:`shard_bucket_plane`;
        ``"row0"`` its first row) and the dict carries ``"shard"``: every
        probe of it is then collective (:func:`probe_rows_sharded`).
        """
        if self.trie.n_nodes >= (1 << 28):
            raise ValueError("vocab trie exceeds the 2^28 packed-node limit")

        def put(arr: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
            return torch.as_tensor(np.ascontiguousarray(arr), device=device).to(dtype)

        fp = []
        for t in self.fp_tables:
            tab = {
                "seed_lo": int(t.seed_lo),
                "seed_hi": int(t.seed_hi),
                "size": int(t.size),
                "hash_mode": t.hash_mode,
            }
            if shard is None:
                tab["bucket"] = put(t.bucket, torch.int32)
            else:
                tab["bucket"] = put(shard_bucket_plane(t.bucket, shard.size)[shard.rank], torch.int32)
                tab["row0"] = shard.rank * shard_rows(t.size, shard.size)
            fp.append(tab)
        out = {
            "uni": put(self.uni, torch.float32),
            "fp": fp,
            "trie_rows": put(self.trie_plane(), torch.int32),
            "trie_word_id": put(self.trie.word_id, torch.int64),
            "uni_unk_row": put(self.uni[self.unk_id], torch.float32),
            "seed_node": put(self.seed_entries(), torch.int64),
            "trie_pack": self.trie_pack,
            "unk_id": int(self.unk_id),
            "eos_id": int(self.eos_id),
            "unk_prob10": float(np.float32(self.unk_prob10)),
            "has_unigrams": bool(self.has_unigrams),
            "order": int(self.order),
        }
        if shard is not None:
            out["shard"] = shard
        return out


def build_device_lm(language_model: LanguageModel, tokens: TokenArrays) -> DeviceLM:
    """Compile a :class:`LanguageModel` into :class:`DeviceLM` tables.

    Three sources feed the same device layout: the Python
    :class:`NGramTables` of an ARPA or ``.ctclm`` model and the native
    engine's exported entries of an ARPA model (tables keyed by id tuples,
    FNV mode; the same entries per bucket row, with the slots possibly in
    a different order), and the :class:`~.kenlm_bin.KenLMTables`
    of a KenLM binary (tables built from its stored chain hashes, mode
    ``kenlm64``).
    """
    from .native import NativeNGramModel

    ngram = language_model.ngram_model
    if isinstance(ngram, KenLMBinaryModel):
        kt = ngram.tables
        order = kt.order
        unk_id = kt.unk_id
        eos_id = kt.vocab.get(EOS_WORD, unk_id)
        unk_prob10 = float(kt.uni[unk_id]["prob"])
        vocab = kt.vocab
        bos_state = kt.begin_sentence_state()
        # kenlm's unigram array is dense by id: every id exists at order 1
        n_vocab = max(len(vocab), 1)
        uni = np.zeros((n_vocab, 4), dtype=np.float32)
        uni[: len(kt.uni), 0] = kt.uni["prob"]
        uni[: len(kt.uni), 1] = kt.uni["backoff"]
        uni[: len(kt.uni), 2] = 1.0
        fp_tables = [
            build_fp_table_from_hashes(keys64, probs, backoffs, n_order)
            for n_order, (keys64, probs, backoffs) in enumerate(kt.raw, start=2)
        ]
    elif isinstance(ngram, NativeNGramModel):
        nat = ngram.native
        order = nat.order
        unk_id = nat.unk_id
        eos_id = nat.eos_id if nat.eos_id >= 0 else unk_id
        unk_prob10 = nat.unk_prob10
        vocab = {w: i for i, w in enumerate(nat.vocab_list())}
        bos_state = ngram.begin_sentence_state()
        # per-order occupied entries straight from the native tables
        uni = np.zeros((max(len(vocab), 1), 4), dtype=np.float32)
        fp_tables = []
        for n_order, exp in enumerate(nat.export_tables(), start=1):
            keys = exp["keys"]
            occupied = keys[:, -1] >= 0
            keys = keys[occupied]
            probs = exp["probs"][occupied]
            backoffs = exp["backoffs"][occupied]
            if n_order == 1:
                wids = keys[:, 0]
                uni[wids, 0] = probs
                uni[wids, 1] = backoffs
                uni[wids, 2] = 1.0
            else:
                fp_tables.append(build_fp_table(keys, probs, backoffs))
    elif isinstance(ngram, NGramModel):
        tables_py: NGramTables = ngram.tables
        order = tables_py.order
        unk_id = tables_py.unk_id
        eos_id = tables_py.vocab.get(EOS_WORD, unk_id)
        uni_unk = tables_py.ngrams[0].get((unk_id,))
        unk_prob10 = float(uni_unk[0]) if uni_unk is not None else -99.0
        vocab = tables_py.vocab
        bos_state = tables_py.begin_sentence_state()
        uni = build_unigram_array(tables_py.ngrams[0], len(vocab))
        fp_tables = []
        for n_order in range(2, order + 1):
            entries = tables_py.ngrams[n_order - 1]
            keys = np.array(list(entries.keys()), dtype=np.int32).reshape(
                len(entries), n_order
            )
            vals = np.array(list(entries.values()), dtype=np.float32).reshape(
                len(entries), 2
            )
            fp_tables.append(build_fp_table(keys, vals[:, 0], vals[:, 1]))
    else:
        raise TypeError(
            f"device tables are built from NGramModel, NativeNGramModel or KenLMBinaryModel "
            f"n-gram models; got {type(ngram).__name__}"
        )

    # the trie's char ids must extend the token char map with vocab-only chars
    char2id = dict(tokens.char2id)
    for word in vocab:
        for ch in word:
            if ch not in char2id:
                char2id[ch] = len(char2id)
    for word in language_model.unigram_set:
        for ch in word:
            if ch not in char2id:
                char2id[ch] = len(char2id)
    trie = build_vocab_trie(vocab, language_model.unigram_set, char2id, unk_id, tokens.char2id)
    seed_node = trie_seed_nodes(trie, tokens)
    ctx_width = max(order - 1, 1)
    start_ctx = np.full(ctx_width, -1, dtype=np.int32)
    for i, wid in enumerate(bos_state):
        start_ctx[ctx_width - len(bos_state) + i] = wid
    dlm = DeviceLM(
        order=order,
        unk_id=unk_id,
        eos_id=eos_id,
        unk_prob10=unk_prob10,
        start_ctx=start_ctx,
        start_ctx_len=len(bos_state),
        start_ctx_backoffs=np.zeros(ctx_width, dtype=np.float32),
        uni=uni,
        fp_tables=fp_tables,
        trie=trie,
        seed_node=seed_node,
        has_unigrams=len(language_model.unigram_set) > 0,
    )
    dlm.start_ctx_backoffs = context_suffix_backoffs(dlm, bos_state)
    return dlm


def build_hotword_tables(
    hotword_unigrams: "object",
    char2id: Dict[str, int],
    tokens: TokenArrays,
    min_nodes: int = 8,
) -> Dict[str, np.ndarray]:
    """Per-call hotword trie as packed arrays (ref language_model.py:115-189).

    Hotwords change per decode call, so these arrays are uploaded per call
    set (the decoder caches a few), not with the LM tables. ``next`` /
    ``seed`` entries are packed (child node id + the child's
    shortest-completion length + terminal flag, see ``HOT_NODE_MASK``) so a
    walk's single read also answers every scoring question; node counts pad
    to a power of two (at least ``min_nodes``) with rows of the packed dead
    entry. ``dead`` is the swallowing node id.
    """
    builder = _TrieBuilder(len(char2id))
    for word in hotword_unigrams:
        ids = []
        ok = True
        for ch in word:
            cid = char2id.get(ch)
            if cid is None:
                ok = False
                break
            ids.append(cid)
        if not ok:
            continue  # contains an undecodable char: can never match
        node = builder.insert(ids, len(word))
        builder.is_uni_word[node] = True
    trie = builder.pack()
    if trie.n_nodes >= (1 << 20):
        raise ValueError("hotword trie exceeds the 2^20 packed-node limit")

    def _pack(nodes: np.ndarray) -> np.ndarray:
        mc = np.minimum(trie.min_completion[nodes], HOT_MINCOMP_MAX).astype(np.int64)
        bits = nodes.astype(np.int64) | (mc << HOT_MINCOMP_SHIFT)
        bits |= np.where(trie.is_uni_word[nodes], HOT_WORD_BIT, 0)
        return bits.astype(np.int32)

    n = trie.n_nodes  # includes the dead node
    n_pad = min_nodes
    while n_pad < n:
        n_pad *= 2
    nxt = np.full(
        (n_pad, trie.next.shape[1]),
        int(_pack(np.array([trie.dead]))[0]),
        dtype=np.int32,
    )
    nxt[:n] = _pack(trie.next)
    return {
        "next": nxt,
        "seed": _pack(trie_seed_nodes(trie, tokens)),
        "dead": np.int32(trie.dead),
    }


def empty_hotword_tables(tokens: TokenArrays) -> Dict[str, np.ndarray]:
    """No-hotword stand-in (root-only trie; every walk lands dead)."""
    return build_hotword_tables([], tokens.char2id, tokens)


# --------------------------------------------------------------------------
# device probes (torch; any leading shape)
# --------------------------------------------------------------------------
def _probe_uni(uni_dev: torch.Tensor, wid: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Dense order-1 lookup: one row read per query, no hashing."""
    rows = uni_dev[wid.clamp(min=0)]
    exists = (rows[..., 2] > 0.5) & (wid >= 0)
    prob = torch.where(exists, rows[..., 0], 0.0)
    backoff = torch.where(exists, rows[..., 1], 0.0)
    return exists, prob, backoff


def probe_fp(tab_dev: Dict, query: torch.Tensor, valid: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Probe one order's table: a single bucket-row read per query.

    ``tab_dev``: {"bucket": i32 [size, _BUCKET_WIDTH], "seed_lo"/"seed_hi"/
    "size": ints}. ``query``: integer ``[..., n]``; ``valid``: bool
    ``[...]``. Returns ``(found, prob, backoff)``. The plain per-order form
    of the probe: :func:`lm_score_words` probes all its orders at once
    through :func:`~pyctcdecode_torch.ops.gather.probe_rows`.
    """
    h, lo, hi = query_hashes(tab_dev, query)
    rows = gather_rows(tab_dev["bucket"], (h % tab_dev["size"]).contiguous())  # [..., _BUCKET_WIDTH]
    return bucket_readout(rows, lo, hi, valid, _BUCKET_SLOTS, _SUB_WIDTH)


def trie_fetch_rows(trie_rows: torch.Tensor, tp: Dict[str, int], nodes: torch.Tensor) -> torch.Tensor:
    """Per-node trie entries ``[..., width]`` from the multi-node-packed plane.

    Slot ``nodes % pack`` of plane row ``nodes // pack``: ``stride`` words a
    slot, of which the node's own ``width`` words are read.
    """
    pack, stride, w = tp["pack"], tp["stride"], tp["width"]
    nodes = nodes.to(torch.int64)
    if pack == 1:
        return gather_rows(trie_rows, nodes.contiguous(), None, stride, w)
    return gather_rows(trie_rows, (nodes // pack).contiguous(), nodes % pack, stride, w)


def probe_rows_sharded(shard: LMShard, full: torch.Tensor, ctx_len: torch.Tensor, tables: Sequence[Dict],
                       slots: int, sub_width: int) -> Tuple[torch.Tensor, ...]:
    """:func:`~pyctcdecode_torch.ops.gather.probe_rows` over row-sharded tables: one round trip.

    The collective probe of the JAX reference (``_probe_fp_sharded``):
    every process gathers all processes' queries (``full`` and ``ctx_len``
    in one ``all_gather``; each process passes the same shape), answers
    them from its own row window in one ``probe_rows`` launch (a query
    outside the window answers nothing), and one ``all_reduce`` sums the
    packed ``(found, prob, backoff)`` planes. Exactly one process owns a
    query's row and the others add zeros, so the sums are exact. Returns
    this process's block, as ``probe_rows`` would on the whole tables.

    It is safe to capture in a CUDA graph: no host sync, every shape fixed
    by ``full``'s and the group's (``shard.size`` and ``shard.rank`` are
    host constants), and ``every`` and ``packed`` are intermediates that a
    capture takes from its graph's pool. The gloo group of the CPU is never
    captured.
    """
    import torch.distributed as dist

    n = full.shape[0]
    query = torch.cat([full, ctx_len[..., None]], dim=-1)
    every = torch.empty((shard.size * n, *query.shape[1:]), dtype=query.dtype, device=query.device)
    dist.all_gather_into_tensor(every, query, group=shard.group)
    found, prob, backoff = probe_rows(
        every[..., :-1].contiguous(), every[..., -1].contiguous(), tables, slots, sub_width
    )
    packed = torch.stack([found.to(torch.float32), prob, backoff])
    dist.all_reduce(packed, group=shard.group)
    mine = packed[:, :, shard.rank * n : (shard.rank + 1) * n]
    return mine[0] > 0.5, mine[1], mine[2]


def lm_score_words(
    dev: Dict,
    ctx: torch.Tensor,
    ctx_len: torch.Tensor,
    wid: torch.Tensor,
    ctx_backoffs: torch.Tensor,
    uni_probe: Optional[Tuple] = None,
    stats_out: Optional[Dict] = None,
) -> Tuple[torch.Tensor, ...]:
    """Batched KenLM-``BaseScore``-equivalent on the device.

    ``ctx``: integer ``[..., order-1]`` right-aligned (-1 pad), ``ctx_len
    [...]``, ``wid [...]``, ``ctx_backoffs [..., order-1]`` (the backoff
    weights of every context suffix, right-aligned, 0 where absent).
    Returns ``(raw10 f32, out_ctx, out_len, out_backoffs)`` matching
    :meth:`NGramTables.raw_score` on float32.

    ``uni_probe`` optionally supplies the word's order-1 probe result
    ``(found, prob, backoff)`` (the engine reads it off the beam's trie
    row). The outgoing state is a suffix of ``context + word``, so its
    suffix backoffs fall out of the same probes. ``stats_out`` (a dict)
    receives ``{"hits": [found_1, ..., found_order]}``, the per-order hit
    masks of the full-suffix probes, for the engine's decode counters. Over
    row-sharded tables (``dev["shard"]``) the probe is collective.
    """
    order = dev["order"]
    unk_prob10 = dev["unk_prob10"]
    ctx_width = max(order - 1, 1)
    wid = wid.to(torch.int64)
    if uni_probe is not None:
        f1, p1, b1 = uni_probe
    else:
        f1, p1, b1 = _probe_uni(dev["uni"], wid)
    if order == 1:
        if stats_out is not None:
            stats_out["hits"] = [f1]
        score = torch.where(f1, p1, unk_prob10)
        zbo = torch.zeros(ctx.shape, dtype=torch.float32, device=ctx.device)
        return score, torch.full_like(ctx, -1), torch.zeros_like(ctx_len), zbo

    full = torch.cat([ctx.to(torch.int64), wid[..., None]], dim=-1)  # [..., order]
    k = ctx_len
    probe_args = (full, k.to(torch.int64).contiguous(), dev["fp"], _BUCKET_SLOTS, _SUB_WIDTH)
    if "shard" in dev:
        fps, pps, bps = probe_rows_sharded(dev["shard"], *probe_args)
    else:  # every order >= 2 at once, valid where k + 1 >= n
        fps, pps, bps = probe_rows(*probe_args)
    found, prob, backoff = [f1, *fps.unbind(0)], [p1, *pps.unbind(0)], [b1, *bps.unbind(0)]
    if stats_out is not None:
        stats_out["hits"] = found
    ctx_bo = [ctx_backoffs[..., ctx_width - j] for j in range(1, order)]

    # longest match over full suffixes
    matched = torch.zeros_like(k)
    best_prob = torch.zeros(wid.shape, dtype=torch.float32, device=wid.device)
    for n in range(1, order + 1):
        matched = torch.where(found[n - 1], n, matched)
        best_prob = torch.where(found[n - 1], prob[n - 1], best_prob)
    no_match = matched == 0
    best_prob = torch.where(no_match, unk_prob10, best_prob)
    matched = torch.where(no_match, 1, matched)

    # backoff accumulation over unmatched context suffixes, ascending j
    # (sequential f32 adds in the same order as the host scorer)
    score = best_prob
    for j in range(1, order):
        use = (j >= matched) & (j <= k)
        score = torch.where(use, score + ctx_bo[j - 1], score)

    # outgoing state: longest suffix of `full` present, capped at order-1
    out_n = torch.zeros_like(k)
    for n in range(1, order):
        out_n = torch.where(found[n - 1], n, out_n)
    positions = torch.arange(ctx_width, device=wid.device)
    tail = full[..., 1:]
    out_ctx = torch.where(positions >= (ctx_width - out_n[..., None]), tail, -1)
    out_bo_cols = []
    for col in range(ctx_width):
        j = ctx_width - col
        out_bo_cols.append(
            torch.where((j <= out_n) & found[j - 1], backoff[j - 1], 0.0)
        )
    out_backoffs = torch.stack(out_bo_cols, dim=-1)
    return score, out_ctx, out_n, out_backoffs
