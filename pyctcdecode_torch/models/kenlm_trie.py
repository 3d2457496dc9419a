"""KenLM binary model ingestion: the TRIE format, without kenlm.

Companion to :mod:`.kenlm_bin` (PROBING): the reference decoder accepts any
KenLM binary by delegating to the kenlm bindings (ref
``language_model.py:422-427``, ``decoder.py:1074``), and ``build_binary
trie`` output is common in memory-constrained deployments. This module
(a copy of the JAX reference package's) reads the TRIE and QUANT_TRIE
layouts directly into the same
:class:`~.kenlm_bin.KenLMTables` the PROBING reader produces, so the host
scorer and the device tables work unchanged.

A TRIE binary *does* store recoverable word tuples (unlike PROBING, which
keeps only hashes): the n-grams form a reversed-suffix trie — level 1 is
the predicted word, level ``m`` is keyed by the ``(m-1)``-th context word
back — stored as bit-packed CSR arrays. The reader decodes every level,
reconstructs the id tuples by walking parents, and keys them with the
kenlm chain hash so all downstream machinery (hash-keyed scoring, device
probe tables built via ``build_fp_table_from_hashes``) is shared with the
PROBING path.

Supported: format version 5, ``model_type`` 2 (TRIE) and 3 (QUANT_TRIE,
kenlm ``build_binary -q N -b M trie``), vocabulary strings present.
ARRAY_ (Bhiksha-compressed pointer) variants are rejected with a message
naming the fix. Like the PROBING reader, this is validated by round-trip
against :func:`write_kenlm_trie` and by exact score equality with the
ARPA scorer on the same model (quantized: equality against the binned
values).

Quantized layout (kenlm ``lm/quantize.{hh,cc}``, SeparatelyQuantize,
version 2): between the vocabulary and the unigram array sits an 8-byte
header ``(version u8, prob_bits u8, backoff_bits u8, 5 pad)`` followed by
the bin-center tables — per middle order a ``2^prob_bits`` f32 prob table
and a ``2^backoff_bits`` f32 backoff table (whose first two slots are the
reserved no-extension/-0.0 and extension/0.0 backoffs), then one
``2^prob_bits`` prob table for the longest order. Middle entries then
pack ``word | prob_idx | backoff_idx | next`` and longest entries
``word | prob_idx``; unigrams stay unquantized.

Layout after the shared header (see ``kenlm_bin``; offsets follow kenlm
``lm/vocab.cc``, ``lm/trie.cc``, ``lm/search_trie.hh``,
``util/bit_packing.hh``):

* SortedVocabulary: u64 entry count (words excluding ``<unk>``), then
  that many sorted u64 murmur hashes, in a region sized for ``counts[0]``
  hashes. Word id = sorted rank + 1; ``<unk>`` = 0.
* Unigram array: ``counts[0] + 2`` entries of ``(f32 prob, f32 backoff,
  u64 next)``; entry ``i``'s children occupy ``[next_i, next_{i+1})`` of
  the first middle level.
* Per middle order ``m`` in ``2..order-1``: ``counts[m-1] + 1`` bit-packed
  entries of ``word (RequiredBits(counts[0]) bits) | prob (31 bits,
  sign-stripped non-positive float) | backoff (32 bits) | next
  (RequiredBits(counts[m]) bits)``, padded to bytes + 8 slack bytes. The
  final entry is a sentinel carrying the end-of-array next pointer.
* Longest order: same with ``word | prob`` only.

Bit packing is little-endian within a u64 window: a field at bit offset
``o`` is ``(u64 at byte o>>3) >> (o & 7)`` masked to width (max 57 bits —
the 63-bit prob+backoff pair is therefore two fields).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from ..ops.hashing import kenlm_chain_host, murmur64
from .kenlm_bin import (
    MODEL_QUANT_TRIE,
    MODEL_TRIE,
    KenLMTables,
    _PROB_BACKOFF,
    _pack_header,
)
from .ngram import UNK_WORD
_TRIE_SEARCH_VERSION = 1  # kenlm trie::TrieSearch::kVersion
_QUANT_VERSION = 2  # kenlm lm/quantize.cc kSeparatelyQuantizeVersion
_SIGN_BIT = np.uint32(0x80000000)

_UNIGRAM_VALUE = np.dtype(
    [("prob", "<f4"), ("backoff", "<f4"), ("next", "<u8")]
)  # lm/trie.hh UnigramValue


def _required_bits(max_value: int) -> int:
    """util::RequiredBits: bits to hold values up to ``max_value``."""
    return int(max_value).bit_length()


def _base_size(entries: int, total_bits: int) -> int:
    """lm/trie.cc BitPacked::BaseSize: bytes incl. sentinel + u64 slack."""
    return ((1 + entries) * total_bits + 7) // 8 + 8


# --------------------------------------------------------------------------
# vectorized bit-packed array access
# --------------------------------------------------------------------------
def _read_bits(buf: np.ndarray, bit_offs: np.ndarray, width: int) -> np.ndarray:
    """Gather ``width``-bit little-endian fields at ``bit_offs`` (u64 out)."""
    if width > 57:
        raise ValueError("bit fields are at most 57 bits (util::ReadInt57)")
    bit_offs = np.asarray(bit_offs, dtype=np.uint64)
    byte = (bit_offs >> np.uint64(3)).astype(np.int64)
    window = buf[byte[:, None] + np.arange(8)].astype(np.uint64)
    word = np.bitwise_or.reduce(
        window << (np.arange(8, dtype=np.uint64) * np.uint64(8)), axis=1
    )
    mask = np.uint64((1 << width) - 1)
    return (word >> (bit_offs & np.uint64(7))) & mask


def _write_bits(
    buf: np.ndarray, bit_offs: np.ndarray, width: int, values: np.ndarray
) -> None:
    """Scatter-OR ``width``-bit fields into a zero-initialized byte buffer.

    Fields never overlap bit ranges, so per-byte OR accumulation is exact
    even where neighboring fields share bytes.
    """
    bit_offs = np.asarray(bit_offs, dtype=np.uint64)
    shifted = np.asarray(values, dtype=np.uint64) << (bit_offs & np.uint64(7))
    byte = (bit_offs >> np.uint64(3)).astype(np.int64)
    parts = (
        shifted[:, None] >> (np.arange(8, dtype=np.uint64) * np.uint64(8))
    ).astype(np.uint8)
    np.bitwise_or.at(buf, byte[:, None] + np.arange(8), parts)


def _float_to_npf31(values: np.ndarray) -> np.ndarray:
    """Non-positive float -> 31-bit payload (sign bit stripped)."""
    return (
        np.asarray(values, dtype=np.float32).view(np.uint32) & ~_SIGN_BIT
    ).astype(np.uint64)


def _npf31_to_float(bits: np.ndarray) -> np.ndarray:
    """31-bit payload -> float with the sign bit restored."""
    return (bits.astype(np.uint32) | _SIGN_BIT).view(np.float32)


# --------------------------------------------------------------------------
# quantization bins (kenlm lm/quantize.cc)
# --------------------------------------------------------------------------
def train_bins(values: np.ndarray, n_bins: int) -> np.ndarray:
    """Equal-population bin centers (kenlm ``MakeBins``): sorted values
    split into ``n_bins`` buckets, center = bucket mean (-inf for an empty
    leading bucket, previous center otherwise)."""
    values = np.sort(np.asarray(values, dtype=np.float32))
    size = len(values)
    centers = np.empty(n_bins, dtype=np.float32)
    start = 0
    for i in range(n_bins):
        finish = (size * (i + 1)) // n_bins
        if finish == start:
            centers[i] = centers[i - 1] if i else -np.inf
        else:
            centers[i] = np.float32(
                np.sum(values[start:finish], dtype=np.float64)
                / (finish - start)
            )
        start = finish
    return centers


def encode_bins(values: np.ndarray, centers: np.ndarray, reserved: int) -> np.ndarray:
    """Nearest-center index (>= ``reserved``) for each value."""
    usable = centers[reserved:]
    pos = np.searchsorted(usable, values)
    lo = np.clip(pos - 1, 0, len(usable) - 1)
    hi = np.clip(pos, 0, len(usable) - 1)
    pick_hi = np.abs(usable[hi] - values) < np.abs(values - usable[lo])
    return np.where(pick_hi, hi, lo).astype(np.uint64) + np.uint64(reserved)


def _parse_quant_tables(
    raw: bytes, path: str, order: int, off: int
) -> Tuple[List[np.ndarray], List[np.ndarray], np.ndarray, int, int, int]:
    """Read the SeparatelyQuantize region; returns per-middle-order prob and
    backoff center tables, the longest-order prob table, the two bit
    widths, and the offset past the region."""
    version, prob_bits, backoff_bits = raw[off], raw[off + 1], raw[off + 2]
    if version != _QUANT_VERSION:
        raise ValueError(
            f"{path!r} uses quantization version {version}; this reader "
            f"implements version {_QUANT_VERSION} (current kenlm)."
        )
    if not prob_bits or not backoff_bits:
        raise ValueError(f"{path!r}: zero quantization bit width.")
    off += 8  # ALIGN8(3-byte header)
    probs: List[np.ndarray] = []
    backoffs: List[np.ndarray] = []
    for _ in range(order - 2):  # middle orders 2..order-1
        probs.append(np.frombuffer(raw, "<f4", 1 << prob_bits, off).copy())
        off += 4 << prob_bits
        backoffs.append(
            np.frombuffer(raw, "<f4", 1 << backoff_bits, off).copy()
        )
        off += 4 << backoff_bits
    longest = np.frombuffer(raw, "<f4", 1 << prob_bits, off).copy()
    off += 4 << prob_bits
    return probs, backoffs, longest, int(prob_bits), int(backoff_bits), off


# --------------------------------------------------------------------------
# reader
# --------------------------------------------------------------------------
def read_kenlm_trie(
    raw: bytes,
    path: str,
    order: int,
    counts: List[int],
    off: int,
    quantized: bool = False,
) -> KenLMTables:
    """Decode a TRIE-format body (header already parsed by the caller)."""
    buf = np.frombuffer(raw, dtype=np.uint8)
    # sorted vocabulary: actual entry count, hashes, region sized by counts[0]
    n_entries = int(np.frombuffer(raw, "<u8", 1, off)[0])
    if n_entries > counts[0]:
        raise ValueError(
            f"{path!r}: vocabulary claims {n_entries} entries but the "
            f"header allots space for {counts[0]}."
        )
    hashes = np.frombuffer(raw, "<u8", n_entries, off + 8).copy()
    off += 8 + 8 * counts[0]
    n_words = n_entries + 1  # + <unk> at id 0

    prob_bits = backoff_bits = 0
    q_probs: List[np.ndarray] = []
    q_backoffs: List[np.ndarray] = []
    q_longest = np.empty(0, dtype=np.float32)
    if quantized:
        (q_probs, q_backoffs, q_longest, prob_bits, backoff_bits, off) = (
            _parse_quant_tables(raw, path, order, off)
        )

    # unigram: dense (prob, backoff, next) by word id, +2 slack entries
    uni_raw = np.frombuffer(raw, _UNIGRAM_VALUE, counts[0] + 2, off)
    off += (counts[0] + 2) * _UNIGRAM_VALUE.itemsize
    bounds = uni_raw["next"][: n_words + 1].astype(np.int64)

    word_bits = _required_bits(counts[0])
    levels: List[Dict[str, np.ndarray]] = []  # per order 2..order
    for m in range(2, order + 1):
        entries = counts[m - 1]
        last = m == order
        if quantized:
            value_bits = prob_bits if last else prob_bits + backoff_bits
        else:
            value_bits = 31 if last else 63
        next_bits = 0 if last else _required_bits(counts[m])
        total = word_bits + value_bits + next_bits
        base = np.arange(entries, dtype=np.uint64) * np.uint64(total)
        words = _read_bits(buf[off:], base, word_bits).astype(np.int64)
        if quantized:
            p_idx = _read_bits(
                buf[off:], base + np.uint64(word_bits), prob_bits
            ).astype(np.int64)
            probs = (q_longest if last else q_probs[m - 2])[p_idx]
            if not last:
                b_idx = _read_bits(
                    buf[off:],
                    base + np.uint64(word_bits + prob_bits),
                    backoff_bits,
                ).astype(np.int64)
                backoffs = q_backoffs[m - 2][b_idx]
        else:
            probs = _npf31_to_float(
                _read_bits(buf[off:], base + np.uint64(word_bits), 31)
            )
            if not last:
                backoffs = _read_bits(
                    buf[off:], base + np.uint64(word_bits + 31), 32
                ).astype(np.uint32).view(np.float32)
        if last:
            backoffs = np.zeros(entries, dtype=np.float32)
            nxt = None
        else:
            nxt = _read_bits(
                buf[off:],
                np.arange(entries + 1, dtype=np.uint64) * np.uint64(total)
                + np.uint64(word_bits + value_bits),
                next_bits,
            ).astype(np.int64)
        if np.any(words >= n_words):
            raise ValueError(
                f"{path!r}: order-{m} entries name word ids beyond the "
                "vocabulary; the file is corrupt or a layout this reader "
                "does not understand."
            )
        if bounds[-1] != entries or np.any(np.diff(bounds) < 0):
            raise ValueError(
                f"{path!r}: order-{m - 1} next pointers do not form a "
                f"monotone CSR ending at {entries}; the file is corrupt."
            )
        levels.append(
            {"word": words, "prob": probs, "backoff": backoffs,
             "parent_bounds": bounds}
        )
        if nxt is not None:
            bounds = nxt
        off += _base_size(entries, total)

    # reconstruct id tuples: level-m entry e extends its parent's (m-1)-gram
    # (the parent covers the newer words) with one older word at the front
    tuples: List[np.ndarray] = [np.arange(n_words, dtype=np.int64)[:, None]]
    for m, lvl in enumerate(levels, start=2):
        n = len(lvl["word"])
        parent = (
            np.searchsorted(lvl["parent_bounds"], np.arange(n), side="right")
            - 1
        )
        tuples.append(
            np.concatenate(
                [lvl["word"][:, None], tuples[m - 2][parent]], axis=1
            )
        )

    # -- vocabulary strings: map via murmur hash -> sorted rank + 1 ---------
    strings = raw[off:].split(b"\x00")
    words_list = [w for w in strings if w]
    vocab: Dict[str, int] = {}
    for w in words_list:
        ws = w.decode("utf-8")
        if ws == UNK_WORD:
            vocab[ws] = 0
            continue
        h = murmur64(w)
        pos = int(np.searchsorted(hashes, np.uint64(h)))
        if pos >= n_entries or hashes[pos] != h:
            raise ValueError(
                f"{path!r}: vocabulary string {ws!r} does not hash into "
                "the sorted id table; the file is corrupt."
            )
        vocab[ws] = pos + 1
    vocab.setdefault(UNK_WORD, 0)
    if len(vocab) != n_words:
        raise ValueError(
            f"{path!r}: {len(vocab)} vocabulary strings for {n_words} ids "
            "(duplicate or missing words)."
        )

    uni = np.zeros(n_words, dtype=_PROB_BACKOFF)
    uni["prob"] = uni_raw["prob"][:n_words]
    uni["backoff"] = uni_raw["backoff"][:n_words]

    grams: List[Dict[int, Tuple[np.float32, np.float32]]] = []
    raw_tabs: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []
    for m, lvl in enumerate(levels, start=2):
        keys = kenlm_chain_host(tuples[m - 1])
        probs = lvl["prob"].astype(np.float32)
        backoffs = lvl["backoff"].astype(np.float32)
        raw_tabs.append((keys, probs, backoffs))
        grams.append(
            dict(zip(keys.tolist(), zip(probs.tolist(), backoffs.tolist())))
        )
    return KenLMTables(order, vocab, uni, grams, raw_tabs, path=path)


# --------------------------------------------------------------------------
# writer
# --------------------------------------------------------------------------
def write_kenlm_trie(
    tables: "object",
    path: str,
    probing_multiplier: float = 1.5,
    quant_bits: "object" = None,
) -> None:
    """Serialize :class:`~.ngram.NGramTables` as a KenLM TRIE binary.

    Word ids follow kenlm's sorted-vocabulary convention (``<unk>`` = 0,
    the rest ranked by murmur hash). N-grams whose suffixes were pruned
    from the model get blank intermediate entries, kenlm-style: the
    blank's prob is its longest surviving suffix's raw prob and its
    backoff is 0 (lm/search_trie.cc BlankManager) — exactly reproducing
    kenlm's (documented) divergence from pure ARPA resolution on pruned
    models.

    ``quant_bits=(prob_bits, backoff_bits)`` writes the QUANT_TRIE layout
    (kenlm ``build_binary -q -b``): values quantize to equal-population
    bin centers (:func:`train_bins`) and entries store bin indices. The
    encoder here picks the nearest center (kenlm's own boundary choice may
    differ by one bin) — the READER is the compatibility surface; this
    writer exists for round-trip tests and synthetic fixtures.
    """
    order = tables.order
    if order < 2:
        raise ValueError("KenLM trie binaries require order >= 2.")
    words = [w for w in tables.vocab if w != UNK_WORD]
    hashes = np.array(
        [murmur64(w.encode("utf-8")) for w in words], dtype=np.uint64
    )
    rank = np.argsort(hashes, kind="stable")
    remap = {UNK_WORD: 0}
    for new_id, i in enumerate(rank, start=1):
        remap[words[i]] = new_id
    old2new = np.zeros(len(tables.vocab), dtype=np.int64)
    for w, old in tables.vocab.items():
        old2new[old] = remap[w]
    n_words = len(remap)

    # per-level node sets: every m-gram plus every length-m suffix of a
    # longer n-gram (stored in remapped ids, normal word order)
    node_vals: List[Dict[Tuple[int, ...], Tuple[float, float]]] = [
        {} for _ in range(order)
    ]
    for n in range(1, order + 1):
        for key, (p, b) in tables.ngrams[n - 1].items():
            t = tuple(int(old2new[w]) for w in key)
            node_vals[n - 1][t] = (float(p), float(b))
    for n in range(order, 2, -1):
        for t in list(node_vals[n - 1]):
            for m in range(n - 1, 1, -1):
                suf = t[n - m:]
                if suf in node_vals[m - 1]:
                    continue
                basis = -99.0  # kenlm asserts a suffix exists; be lenient
                for j in range(m - 1, 0, -1):
                    hit = node_vals[j - 1].get(suf[m - j:])
                    if hit is not None:
                        basis = hit[0]
                        break
                node_vals[m - 1][suf] = (basis, 0.0)

    # trie ordering: level-m entries grouped by parent (their (m-1)-suffix)
    # in the parent's index order, sorted by the new oldest word within
    index_of: Dict[Tuple[int, ...], int] = {}
    ordered: List[List[Tuple[int, ...]]] = [[]]
    for wid in range(n_words):
        index_of[(wid,)] = wid
    counts = [n_words]
    level_entries: List[List[Tuple[int, ...]]] = []
    for m in range(2, order + 1):
        ents = sorted(
            node_vals[m - 1], key=lambda t: (index_of[t[1:]], t[0])
        )
        for i, t in enumerate(ents):
            index_of[t] = i
        level_entries.append(ents)
        counts.append(len(ents))

    # per-level value arrays (train quantization bins before packing)
    level_probs = [
        np.array(
            [node_vals[m - 1][t][0] for t in level_entries[m - 2]],
            dtype=np.float32,
        )
        for m in range(2, order + 1)
    ]
    level_backoffs = [
        np.array(
            [node_vals[m - 1][t][1] for t in level_entries[m - 2]],
            dtype=np.float32,
        )
        for m in range(2, order)
    ]

    out = [
        _pack_header(
            order,
            counts,
            probing_multiplier,
            has_vocab=True,
            model_type=MODEL_QUANT_TRIE if quant_bits else MODEL_TRIE,
            search_version=_TRIE_SEARCH_VERSION,
        )
    ]
    # sorted vocabulary (region sized for counts[0] hashes)
    vocab_region = np.zeros(counts[0], dtype=np.uint64)
    vocab_region[: len(hashes)] = hashes[rank]
    out.append(np.uint64(len(hashes)).tobytes())
    out.append(vocab_region.tobytes())

    q_probs: List[np.ndarray] = []
    q_backoffs: List[np.ndarray] = []
    q_longest = np.empty(0, dtype=np.float32)
    if quant_bits:
        prob_bits, backoff_bits = quant_bits
        if not (1 <= prob_bits <= 25 and 2 <= backoff_bits <= 25):
            # backoff bins reserve 2 slots (no-extension/-0.0 and 0.0), so
            # backoff_bits=1 leaves zero trainable centers (encode_bins
            # would index an empty array)
            raise ValueError(
                "quant_bits must satisfy 1 <= prob_bits <= 25 and "
                "2 <= backoff_bits <= 25"
            )
        out.append(
            bytes([_QUANT_VERSION, prob_bits, backoff_bits]) + b"\x00" * 5
        )
        for m in range(2, order):
            q_probs.append(train_bins(level_probs[m - 2], 1 << prob_bits))
            bo = level_backoffs[m - 2]
            centers = np.concatenate(
                [
                    np.array([-0.0, 0.0], dtype=np.float32),  # reserved
                    train_bins(bo[bo != 0.0], (1 << backoff_bits) - 2),
                ]
            )
            q_backoffs.append(centers)
            out.append(q_probs[-1].tobytes())
            out.append(centers.tobytes())
        q_longest = train_bins(level_probs[order - 2], 1 << prob_bits)
        out.append(q_longest.tobytes())

    # unigram array with CSR next pointers into level 2
    uni = np.zeros(counts[0] + 2, dtype=_UNIGRAM_VALUE)
    for (wid,), (p, b) in node_vals[0].items():
        uni[wid]["prob"] = p
        uni[wid]["backoff"] = b
    child_count = np.zeros(n_words + 1, dtype=np.int64)
    if order >= 2:
        for t in level_entries[0]:
            child_count[t[1]] += 1
    nxt = np.concatenate([[0], np.cumsum(child_count[:n_words])])
    uni["next"][: n_words + 1] = nxt
    uni["next"][n_words + 1:] = nxt[-1]
    out.append(uni.tobytes())

    # bit-packed middle + longest levels
    word_bits = _required_bits(counts[0])
    for m in range(2, order + 1):
        ents = level_entries[m - 2]
        n = len(ents)
        last = m == order
        if quant_bits:
            value_bits = prob_bits if last else prob_bits + backoff_bits
        else:
            value_bits = 31 if last else 63
        next_bits = 0 if last else _required_bits(counts[m])
        total = word_bits + value_bits + next_bits
        buf = np.zeros(_base_size(n, total), dtype=np.uint8)
        base = np.arange(n, dtype=np.uint64) * np.uint64(total)
        word_arr = np.array([t[0] for t in ents], dtype=np.uint64)
        probs = level_probs[m - 2]
        _write_bits(buf, base, word_bits, word_arr)
        if quant_bits:
            table = q_longest if m == order else q_probs[m - 2]
            _write_bits(
                buf,
                base + np.uint64(word_bits),
                prob_bits,
                encode_bins(probs, table, 0),
            )
        else:
            _write_bits(
                buf, base + np.uint64(word_bits), 31, _float_to_npf31(probs)
            )
        if m < order:
            backoffs = level_backoffs[m - 2]
            if quant_bits:
                # reserved slots: 0 = no-extension (-0.0), 1 = extension (0.0)
                idx = encode_bins(backoffs, q_backoffs[m - 2], 2)
                zero = backoffs == 0.0
                idx = np.where(
                    zero, np.where(np.signbit(backoffs), 0, 1), idx
                ).astype(np.uint64)
                _write_bits(
                    buf,
                    base + np.uint64(word_bits + prob_bits),
                    backoff_bits,
                    idx,
                )
            else:
                _write_bits(
                    buf,
                    base + np.uint64(word_bits + 31),
                    32,
                    backoffs.view(np.uint32).astype(np.uint64),
                )
            kid_count = np.zeros(n + 1, dtype=np.int64)
            for t in level_entries[m - 1]:
                kid_count[index_of[t[1:]]] += 1
            nxt = np.concatenate([[0], np.cumsum(kid_count[:n])])
            _write_bits(
                buf,
                np.arange(n + 1, dtype=np.uint64) * np.uint64(total)
                + np.uint64(word_bits + value_bits),
                next_bits,
                nxt.astype(np.uint64),
            )
        out.append(buf.tobytes())

    # trailing vocabulary strings in id order, <unk> first
    id2word = sorted(remap, key=remap.__getitem__)
    out.append(b"".join(w.encode("utf-8") + b"\x00" for w in id2word))
    with open(path, "wb") as fh:
        for blob in out:
            fh.write(blob)
