"""KenLM binary model ingestion: the PROBING format, without kenlm.

The reference decoder accepts KenLM binaries by handing the path to the
kenlm C++ bindings (ref ``language_model.py:422-427``, ``decoder.py:1074``),
so real deployments ship ``.bin`` files and often no longer have the ARPA.
This package has no kenlm dependency; this module reads the PROBING
binary layout directly into numpy arrays (a copy of the JAX reference
package's reader and writer, with a vectorized probing insert).

A probing binary stores no n-gram word tuples — only each n-gram's 64-bit
rolling hash (``kenlm_chain``) with its (prob, backoff) payload, plus a
dense unigram array and the vocabulary strings. Tuples are therefore
unrecoverable, and :class:`KenLMTables` scores by recomputing the hash
chain per lookup instead of by tuple maps. That suits the device engine
well: kenlm's key already *is* a 64-bit fingerprint, so the device probe
tables are built straight from the stored hashes
(``device_tables.build_fp_table_from_hashes``) and the device probe
(``probe_rows`` in its ``kenlm`` mode) recomputes the same chain from the
query ids — no conversion step, no ARPA.

Supported: format version 5, ``model_type`` 0 (PROBING) here plus 2/3
(TRIE and QUANT_TRIE, dispatched to :mod:`.kenlm_trie`), vocabulary
strings present (kenlm writes them unless built with
``include_vocab=false``). ARRAY (Bhiksha) trie and REST binaries are
rejected with a message naming the fix (rebuild with ``build_binary
probing``/``trie`` without ``-a``, or load the ARPA). The reader is validated by round-trip against this module's
writer and by exact score equality with the ARPA scorer on the same model;
the header sanity block is checked field-for-field, so a file that loads
is structurally sound.

Layout (little-endian; offsets follow kenlm ``lm/binary_format.cc``,
``lm/vocab.cc``, ``lm/search_hashed.hh``, ``util/probing_hash_table.hh``):

* ``Sanity`` block, 88 bytes: magic string (56B, zero-padded), float
  0.0 / 1.0 / -0.5, u32 1, u32 0xFFFFFFFF, pad, u64 1 — a serialized
  struct the original code memcmp's to catch endianness/ABI mismatches.
* ``FixedWidthParameters``, 20 bytes at offset 88: u8 order, f32
  probing multiplier, i32 model type, u8 has-vocabulary, u32 search
  version.
* u64 per-order counts at offset 108; header padded to a multiple of 8.
* Vocabulary: u64 word count ("bound"), then an open-addressing table of
  12-byte ``(u64 murmur64(word), u32 id)`` entries (empty key 0).
* Search: dense ``(f32 prob, f32 backoff)`` unigram array indexed by word
  id (count+1 rows); per middle order an open-addressing table of 16-byte
  ``(u64 chain-hash, f32 prob, f32 backoff)`` entries; the longest order
  packs 12-byte ``(u64 chain-hash, f32 prob)`` entries. All tables use
  ``max(entries+1, int(multiplier*entries))`` buckets, ideal slot
  ``key % buckets``, circular linear probing, empty key 0.
* Vocabulary strings: the words in id order, NUL-terminated, at the end.
"""
from __future__ import annotations

import logging
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..ops.hashing import KENLM_MUL_A, KENLM_MUL_B, kenlm_chain_host, murmur64
from .ngram import BOS_WORD, EOS_WORD, UNK_WORD

logger = logging.getLogger(__name__)

MAGIC = b"mmap lm http://kheafield.com/code format version 5\n\x00"
_MAGIC_FIELD = 56  # ALIGN8(len(MAGIC))
_SANITY_BYTES = 88
_PARAMS_OFFSET = _SANITY_BYTES
_COUNTS_OFFSET = _SANITY_BYTES + 20
_MASK64 = (1 << 64) - 1

MODEL_PROBING = 0
MODEL_TRIE = 2
MODEL_QUANT_TRIE = 3
_MODEL_NAMES = {
    0: "PROBING",
    1: "REST_PROBING",
    2: "TRIE",
    3: "QUANT_TRIE",
    4: "ARRAY_TRIE",
    5: "QUANT_ARRAY_TRIE",
}

_VOCAB_ENTRY = np.dtype([("key", "<u8"), ("value", "<u4")])  # 12 bytes
_MIDDLE_ENTRY = np.dtype([("key", "<u8"), ("prob", "<f4"), ("backoff", "<f4")])
_LONGEST_ENTRY = np.dtype([("key", "<u8"), ("prob", "<f4")])  # 12 bytes
_PROB_BACKOFF = np.dtype([("prob", "<f4"), ("backoff", "<f4")])


def _align8(n: int) -> int:
    return (n + 7) & ~7


def _buckets(entries: int, multiplier: float) -> int:
    """kenlm ``ProbingHashTable::Size``: bucket count for ``entries``."""
    return max(entries + 1, int(multiplier * float(entries)))


def _chain1(ids: Tuple[int, ...]) -> int:
    """Scalar kenlm chain hash (python ints; hot in host scoring).

    Newest word first, context folded nearest-to-oldest — see
    :func:`~pyctcdecode_torch.ops.hashing.kenlm_chain_host`.
    """
    h = ids[-1]
    for w in ids[-2::-1]:
        h = ((h * KENLM_MUL_A) ^ ((w + 1) * KENLM_MUL_B)) & _MASK64
    return h


# --------------------------------------------------------------------------
# header
# --------------------------------------------------------------------------
def _pack_header(
    order: int,
    counts: List[int],
    multiplier: float,
    has_vocab: bool,
    model_type: int = MODEL_PROBING,
    search_version: int = 0,
) -> bytes:
    sanity = bytearray(_SANITY_BYTES)
    sanity[: len(MAGIC)] = MAGIC
    sanity[56:60] = np.float32(0.0).tobytes()
    sanity[60:64] = np.float32(1.0).tobytes()
    sanity[64:68] = np.float32(-0.5).tobytes()
    sanity[68:72] = np.uint32(1).tobytes()
    sanity[72:76] = np.uint32(0xFFFFFFFF).tobytes()
    sanity[80:88] = np.uint64(1).tobytes()
    params = bytearray(20)
    params[0] = order
    params[4:8] = np.float32(multiplier).tobytes()
    params[8:12] = np.int32(model_type).tobytes()
    params[12] = 1 if has_vocab else 0
    params[16:20] = np.uint32(search_version).tobytes()
    blob = bytes(sanity) + bytes(params) + np.asarray(counts, "<u8").tobytes()
    return blob + b"\x00" * (_align8(len(blob)) - len(blob))


def _read_header(raw: bytes, path: str):
    if len(raw) < _COUNTS_OFFSET + 8 or not raw.startswith(MAGIC[:51]):
        if raw.startswith(b"mmap lm http://"):
            raise ValueError(
                f"{path!r} is a KenLM binary of an unsupported format "
                "version (this reader implements version 5); rebuild it "
                "with a current kenlm build_binary, or load the ARPA."
            )
        raise ValueError(
            f"{path!r} does not start with the KenLM binary magic string."
        )
    order = raw[_PARAMS_OFFSET]
    multiplier = float(np.frombuffer(raw, "<f4", 1, _PARAMS_OFFSET + 4)[0])
    model_type = int(np.frombuffer(raw, "<i4", 1, _PARAMS_OFFSET + 8)[0])
    has_vocab = bool(raw[_PARAMS_OFFSET + 12])
    if model_type not in (MODEL_PROBING, MODEL_TRIE, MODEL_QUANT_TRIE):
        name = _MODEL_NAMES.get(model_type, f"#{model_type}")
        raise ValueError(
            f"{path!r} is a KenLM {name} binary; only the PROBING, TRIE "
            "and QUANT_TRIE layouts are readable here. Rebuild it with "
            "`build_binary probing model.arpa model.bin` (or `build_binary "
            "trie` without -a), or pass the ARPA file instead."
        )
    counts = [
        int(c) for c in np.frombuffer(raw, "<u8", order, _COUNTS_OFFSET)
    ]
    if order < 2:
        raise ValueError(
            f"{path!r} declares order {order}; KenLM binary models are "
            "order >= 2."
        )
    body = _align8(_COUNTS_OFFSET + 8 * order)
    return order, multiplier, has_vocab, counts, body, model_type


# --------------------------------------------------------------------------
# writer
# --------------------------------------------------------------------------
def _insert_probing(table: np.ndarray, keys: np.ndarray, payload) -> None:
    """Circular linear-probe insertion into a zeroed structured bucket array.

    Keys go in ascending ideal slot (``key % buckets``, stable), each into
    the first free slot at or after its ideal one, wrapping at the end.
    In that order the slots taken before any wrap are a running maximum:
    key ``i`` lands at ``max(ideal_i, slot_(i-1) + 1)``. The keys pushed
    past the last bucket then take the free slots from slot 0 on, in order,
    as the one-key-at-a-time loop would (every slot from their ideal one to
    the end is taken). The bytes equal the loop's (tests hold them to the
    JAX reference package's writer).
    """
    buckets = len(table)
    n = len(keys)
    if n == 0:
        return
    ideal = (keys % np.uint64(buckets)).astype(np.int64)
    order = np.argsort(ideal, kind="stable")
    rank = np.arange(n, dtype=np.int64)
    slot = rank + np.maximum.accumulate(ideal[order] - rank)
    over = slot >= buckets
    if over.any():
        free = np.ones(buckets, dtype=bool)
        free[slot[~over]] = False
        slot[over] = np.flatnonzero(free)[: int(over.sum())]
    table["key"][slot] = keys[order]
    for name, arr in payload:
        table[name][slot] = np.asarray(arr)[order]


def write_kenlm_binary(
    tables: "object", path: str, probing_multiplier: float = 1.5
) -> None:
    """Serialize :class:`~.ngram.NGramTables` as a KenLM PROBING binary.

    Word ids are remapped to kenlm's convention (``<unk>`` = 0, the rest
    contiguous); scores are id-invariant so a round trip through
    :func:`read_kenlm_binary` reproduces them exactly.
    """
    order = tables.order
    if order < 2:
        raise ValueError("KenLM probing binaries require order >= 2.")
    # id remap: <unk> first, everything else in current-id order
    id2word = sorted(tables.vocab, key=tables.vocab.__getitem__)
    id2word.remove(UNK_WORD)
    id2word.insert(0, UNK_WORD)
    remap = np.zeros(len(tables.vocab), dtype=np.uint32)
    for new_id, word in enumerate(id2word):
        remap[tables.vocab[word]] = new_id
    vocab_n = len(id2word)
    counts = [vocab_n] + [len(t) for t in tables.ngrams[1:]]

    out = [_pack_header(order, counts, probing_multiplier, has_vocab=True)]
    # vocabulary: bound + hash table (everything but <unk> is inserted)
    out.append(np.uint64(vocab_n).tobytes())
    vtab = np.zeros(_buckets(vocab_n, probing_multiplier), dtype=_VOCAB_ENTRY)
    vkeys = np.array(
        [murmur64(w.encode("utf-8")) for w in id2word[1:]], dtype=np.uint64
    )
    _insert_probing(
        vtab, vkeys, [("value", np.arange(1, vocab_n, dtype=np.uint32))]
    )
    out.append(vtab.tobytes())
    # unigram array by (remapped) id
    uni = np.zeros(vocab_n + 1, dtype=_PROB_BACKOFF)
    for (wid,), (p, b) in tables.ngrams[0].items():
        uni[remap[wid]] = (p, b)
    out.append(uni.tobytes())
    # middle + longest orders, keyed by the kenlm chain over remapped ids
    for n in range(2, order + 1):
        grams = tables.ngrams[n - 1]
        ids = remap[
            np.array(list(grams), dtype=np.int64).reshape(len(grams), n)
        ].astype(np.int64)
        keys = kenlm_chain_host(ids)
        probs = np.fromiter((v[0] for v in grams.values()), np.float32, len(grams))
        dtype = _MIDDLE_ENTRY if n < order else _LONGEST_ENTRY
        tab = np.zeros(_buckets(len(grams), probing_multiplier), dtype=dtype)
        payload = [("prob", probs)]
        if n < order:
            backoffs = np.fromiter(
                (v[1] for v in grams.values()), np.float32, len(grams)
            )
            payload.append(("backoff", backoffs))
        _insert_probing(tab, keys, payload)
        out.append(tab.tobytes())
    # trailing vocabulary strings in id order
    out.append(b"".join(w.encode("utf-8") + b"\x00" for w in id2word))
    with open(path, "wb") as fh:
        for blob in out:
            fh.write(blob)


# --------------------------------------------------------------------------
# reader
# --------------------------------------------------------------------------
class KenLMTables:
    """Hash-keyed n-gram tables read from a KenLM PROBING binary.

    Drop-in for :class:`~.ngram.NGramTables` everywhere the decoder scores
    (same ``raw_score`` contract, same float32 accumulation); the
    difference is representational: lookups hash the query ids instead of
    consulting tuple maps, because the file never stored the tuples.
    """

    def __init__(
        self,
        order: int,
        vocab: Dict[str, int],
        uni: np.ndarray,
        grams: List[Dict[int, Tuple[np.float32, np.float32]]],
        raw: List[Tuple[np.ndarray, np.ndarray, np.ndarray]],
        path: Optional[str] = None,
    ) -> None:
        self.order = order
        self.vocab = vocab
        self.uni = uni  # structured (prob, backoff) by word id
        self.grams = grams  # grams[i]: chain-hash -> values, key length i+2
        self.raw = raw  # per order >= 2: (keys u64, probs, backoffs) arrays
        self.path = path
        self.unk_id = vocab[UNK_WORD]
        self._n_words = len(vocab)

    # -- vocabulary ---------------------------------------------------------
    def word_id(self, word: str) -> int:
        return self.vocab.get(word, self.unk_id)

    def __contains__(self, word: str) -> bool:
        wid = self.vocab.get(word)
        return wid is not None and wid != self.unk_id

    # -- scoring ------------------------------------------------------------
    def raw_score(
        self, context: Tuple[int, ...], word_id: int
    ) -> Tuple[float, Tuple[int, ...]]:
        """log10 p(word | context) and outgoing state (KenLM BaseScore)."""
        full = context[-(self.order - 1):] + (word_id,)
        k = len(full) - 1
        matched = 0
        prob = np.float32(0.0)
        for n in range(len(full), 1, -1):
            hit = self.grams[n - 2].get(_chain1(full[-n:]))
            if hit is not None:
                matched, prob = n, hit[0]
                break
        if matched == 0:
            wid = word_id if 0 <= word_id < self._n_words else self.unk_id
            matched, prob = 1, self.uni[wid]["prob"]
        score = np.float32(prob)
        for j in range(matched, k + 1):
            ctx = full[-j - 1:-1]
            if j == 1:
                if 0 <= ctx[0] < self._n_words:
                    score = np.float32(score + self.uni[ctx[0]]["backoff"])
            else:
                ent = self.grams[j - 2].get(_chain1(ctx))
                if ent is not None:
                    score = np.float32(score + ent[1])
        max_state = min(len(full), self.order - 1)
        out_state: Tuple[int, ...] = ()
        for n in range(max_state, 1, -1):
            if _chain1(full[-n:]) in self.grams[n - 2]:
                out_state = full[-n:]
                break
        if not out_state and 0 <= full[-1] < self._n_words:
            out_state = full[-1:]
        return float(score), out_state

    def begin_sentence_state(self) -> Tuple[int, ...]:
        """KenLM BeginSentenceState analog: <s> context."""
        bos = self.vocab.get(BOS_WORD)
        return (bos,) if bos is not None else ()

    def null_context_state(self) -> Tuple[int, ...]:
        return ()


def read_kenlm_binary(path: str) -> KenLMTables:
    """Load a KenLM ``.bin``/``.binary`` (PROBING, TRIE or QUANT_TRIE)."""
    with open(path, "rb") as fh:
        raw = fh.read()
    order, multiplier, has_vocab, counts, off, model_type = _read_header(
        raw, path
    )
    if not has_vocab:
        raise ValueError(
            f"{path!r} was built without vocabulary strings "
            "(include_vocab=false); the decoder needs the words. Rebuild "
            "the binary with vocabulary included, or load the ARPA."
        )
    if model_type in (MODEL_TRIE, MODEL_QUANT_TRIE):
        from .kenlm_trie import read_kenlm_trie

        return read_kenlm_trie(
            raw, path, order, counts, off,
            quantized=model_type == MODEL_QUANT_TRIE,
        )
    # vocabulary hash table: murmur64(word) -> id. Word ids are recovered
    # by hashing the trailing strings through this table rather than by
    # position, so the reader is agnostic to whether the strings section
    # includes <unk> or starts at id 0 or 1 (conventions differ between
    # writers; kenlm's own enumeration starts at id 1 with <unk> fixed 0).
    bound = int(np.frombuffer(raw, "<u8", 1, off)[0])
    off += 8
    n_buckets = _buckets(counts[0], multiplier)
    vtab = np.frombuffer(raw, _VOCAB_ENTRY, n_buckets, off)
    occ = vtab["key"] != 0
    hash2id = dict(
        zip(vtab["key"][occ].tolist(), vtab["value"][occ].tolist())
    )
    off += n_buckets * _VOCAB_ENTRY.itemsize
    # unigram dense array
    uni = np.frombuffer(raw, _PROB_BACKOFF, counts[0] + 1, off)[: counts[0]]
    off += (counts[0] + 1) * _PROB_BACKOFF.itemsize
    grams: List[Dict[int, Tuple[np.float32, np.float32]]] = []
    raw_tabs: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []
    for n in range(2, order + 1):
        dtype = _MIDDLE_ENTRY if n < order else _LONGEST_ENTRY
        nb = _buckets(counts[n - 1], multiplier)
        tab = np.frombuffer(raw, dtype, nb, off)
        off += nb * dtype.itemsize
        occ = tab["key"] != 0
        keys = tab["key"][occ]
        probs = tab["prob"][occ].astype(np.float32)
        backoffs = (
            tab["backoff"][occ].astype(np.float32)
            if n < order
            else np.zeros(len(keys), dtype=np.float32)
        )
        raw_tabs.append((keys.copy(), probs, backoffs))
        grams.append(
            dict(
                zip(
                    keys.tolist(),
                    zip(probs.tolist(), backoffs.tolist()),
                )
            )
        )
    words = [w for w in raw[off:].split(b"\x00") if w]
    vocab: Dict[str, int] = {}
    for w in words:
        ws = w.decode("utf-8")
        if ws == UNK_WORD:
            vocab[ws] = 0
            continue
        wid = hash2id.get(murmur64(w))
        if wid is None:
            raise ValueError(
                f"{path!r}: vocabulary string {ws!r} does not hash into "
                "the stored id table; the file is corrupt."
            )
        vocab[ws] = int(wid)
    vocab.setdefault(UNK_WORD, 0)  # kenlm fixes <unk> = 0, strings omit it
    if len(vocab) < bound:
        raise ValueError(
            f"{path!r}: vocabulary strings section resolves to "
            f"{len(vocab)} words but the header promises {bound}."
        )
    return KenLMTables(order, vocab, uni.copy(), grams, raw_tabs, path=path)


class KenLMBinaryModel:
    """N-gram model over :class:`KenLMTables` (KenLM ``.bin`` backend).

    Same surface as :class:`~.ngram.NGramModel`, so
    :class:`~.language_model.LanguageModel` and both decode engines accept
    it interchangeably.
    """

    def __init__(self, tables: KenLMTables) -> None:
        self._tables = tables

    @classmethod
    def from_file(cls, path: str) -> "KenLMBinaryModel":
        return cls(read_kenlm_binary(path))

    @property
    def tables(self) -> KenLMTables:
        return self._tables

    @property
    def order(self) -> int:
        return self._tables.order

    @property
    def path(self) -> Optional[str]:
        return self._tables.path

    def __contains__(self, word: str) -> bool:
        return word in self._tables

    def begin_sentence_state(self) -> Tuple[int, ...]:
        return self._tables.begin_sentence_state()

    def null_context_state(self) -> Tuple[int, ...]:
        return self._tables.null_context_state()

    def raw_score_word(
        self, state: Tuple[int, ...], word: str
    ) -> Tuple[float, Tuple[int, ...]]:
        """log10 p(word | state) plus outgoing state (KenLM BaseScore)."""
        return self._tables.raw_score(state, self._tables.word_id(word))

    def raw_end_score(self, state: Tuple[int, ...]) -> float:
        """log10 p(</s> | state)."""
        score, _ = self._tables.raw_score(
            state, self._tables.word_id(EOS_WORD)
        )
        return score

    def vocab_words(self) -> List[str]:
        """The vocabulary in id order (from the binary's strings section)."""
        return sorted(self._tables.vocab, key=self._tables.vocab.__getitem__)
