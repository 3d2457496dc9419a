"""KenLM binaries and ``.ctclm`` in the port, held against the JAX package.

Every model file is written here, by the JAX package's writers, from the
inline ARPA models of ``torch_cases`` or a small seeded parity 3-gram, so
the port's readers are held against files they did not write:

* the KenLM hashes (``murmur64``, the chain on the host, in u32 lanes and on
  torch int64 lanes) against the JAX package's, bit for bit, on id rows of
  widths 2-5 with ids near ``2**31`` and ``2**32 - 2``;
* the PROBING, TRIE and QUANT_TRIE readers: vocabulary, unigram array, the
  raw hash tables and ``raw_score_word`` over seeded word sequences;
* the KenLM-keyed device tables (``build_fp_table_from_hashes``: JAX's
  buckets, slots and values, with fingerprint lanes that keep all 64 bits
  of the chain where JAX's fold them to 32 and fail to build at scale;
  ``DeviceLM.from_numpy``; ``probe_rows_ref`` in KenLM mode through
  ``lm_score_words`` against JAX's ``lm_score_words_jnp``);
* the device decode from a binary (dense, the serving options, a stream of 3
  chunks, a two-member ``MultiLanguageModel`` mixing an ARPA and a binary
  member) against the JAX engine from the same files: texts, ``text_frames``
  and ``last_lm_state`` identical, scores within 1e-4 (both engines score in
  float32);
* the host oracle from a binary against JAX's host oracle, to the bit;
* ``open_ngram_file``'s dispatch and refusals, and the port's PROBING
  writer, byte-equal to JAX's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyctcdecode_torch as P
from pyctcdecode_torch.evaluation import make_parity_arpa
from pyctcdecode_torch.models import device_tables as tdt
from pyctcdecode_torch.models import kenlm_bin as tkb
from pyctcdecode_torch.models.ngram import load_unigram_set_from_arpa, open_ngram_file
from pyctcdecode_torch.ops import gather as tg
from pyctcdecode_torch.ops import hashing as th
from pyctcdecode_torch.ops.tokens import build_token_arrays as t_tokens
from pyctcdecode_tpu import Alphabet as JAlphabet
from pyctcdecode_tpu import BeamSearchDecoderCTC as JBeamSearchDecoderCTC
from pyctcdecode_tpu import LanguageModel as JLanguageModel
from pyctcdecode_tpu import MultiLanguageModel as JMultiLanguageModel
from pyctcdecode_tpu import TPUBeamSearchDecoderCTC
from pyctcdecode_tpu.models import device_tables as jdt
from pyctcdecode_tpu.models import kenlm_bin as jkb
from pyctcdecode_tpu.models.binfmt import write_binary
from pyctcdecode_tpu.models.kenlm_trie import write_kenlm_trie
from pyctcdecode_tpu.models.native import open_ngram_file as j_open_ngram_file
from pyctcdecode_tpu.models.ngram import read_arpa
from pyctcdecode_tpu.ops import hashing as jh
from pyctcdecode_tpu.ops.tokens import build_token_arrays as j_tokens

from .helpers import SAMPLE_LABELS, TEST_LOGITS
from .torch_cases import ARPA, ARPA_2GRAM, UNIGRAMS, assert_same_beams, assert_same_views, word_logits
from .torch_cases import jax_native, one_torch_thread  # noqa: F401  (autouse fixtures)

FORMATS = ("probing", "trie", "quant_trie")
MEMBER_B = dict(alpha=0.3, beta=2.0, unk_score_offset=-6.0, score_boundary=False)


def _write(tables, path, fmt):
    if fmt == "probing":
        jkb.write_kenlm_binary(tables, path)
    elif fmt == "trie":
        write_kenlm_trie(tables, path)
    else:
        write_kenlm_trie(tables, path, quant_bits=(4, 4))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The inline 3-gram as ARPA, as a PROBING, TRIE and QUANT_TRIE binary and as .ctclm; the 2-gram as ARPA."""
    root = tmp_path_factory.mktemp("lm")
    paths = {"arpa": str(root / "bb3.arpa"), "arpa2": str(root / "bb2.arpa")}
    with open(paths["arpa"], "w") as fh:
        fh.write(ARPA)
    with open(paths["arpa2"], "w") as fh:
        fh.write(ARPA_2GRAM)
    tables = read_arpa(paths["arpa"])
    for fmt in FORMATS:
        paths[fmt] = str(root / f"bb3_{fmt}.bin")
        _write(tables, paths[fmt], fmt)
    paths["ctclm"] = str(root / "bb3.ctclm")
    write_binary(tables, paths["ctclm"])
    return paths


@pytest.fixture(scope="module")
def parity(tmp_path_factory):
    """A seeded parity 3-gram (400 words) and its three binaries, for the readers and the tables."""
    root = tmp_path_factory.mktemp("parity")
    arpa = str(root / "small3.arpa")
    make_parity_arpa(arpa, n_vocab=400, n_bigrams=3000, n_trigrams=2000)
    tables = read_arpa(arpa)
    paths = {"arpa": arpa, "tables": tables}
    for fmt in FORMATS:
        paths[fmt] = str(root / f"small3_{fmt}.bin")
        _write(tables, paths[fmt], fmt)
    return paths


# ---- hashes ------------------------------------------------------------------
@pytest.mark.parametrize("width", [2, 3, 4, 5])
def test_kenlm_hashes_match_jax(width):
    rng = np.random.RandomState(width)
    ids = np.concatenate([
        rng.randint(0, 1 << 20, size=(200, width)),
        (1 << 31) + rng.randint(-3, 3, size=(40, width)),
        (1 << 32) - 2 - rng.randint(0, 3, size=(40, width)),
        rng.randint(0, (1 << 32) - 1, size=(200, width), dtype=np.int64),
    ]).astype(np.int64)
    want = jh.kenlm_chain_host(ids)
    np.testing.assert_array_equal(th.kenlm_chain_host(ids), want)
    j_lo, j_hi = jh.kenlm_chain(np, ids.astype(np.uint32))
    t_lo, t_hi = th.kenlm_chain(np, ids.astype(np.uint32))
    np.testing.assert_array_equal(t_lo, j_lo)
    np.testing.assert_array_equal(t_hi, j_hi)
    # below 2**32 - 1 the u32 lanes are the u64 chain
    np.testing.assert_array_equal(j_lo.astype(np.uint64) | (j_hi.astype(np.uint64) << np.uint64(32)), want)
    jj_lo, jj_hi = jh.kenlm_chain(jnp, jnp.asarray(ids.astype(np.uint32)))
    np.testing.assert_array_equal(np.asarray(jj_lo), j_lo)
    np.testing.assert_array_equal(np.asarray(jj_hi), j_hi)
    # the torch twin on int64 lanes: the ids as given and as int32 bit patterns (-1 pads included)
    for arr in (ids, ids.astype(np.uint32).view(np.int32)):
        lo, hi = th.kenlm_chain_t(torch.as_tensor(arr))
        np.testing.assert_array_equal(lo.numpy(), j_lo.astype(np.int64))
        np.testing.assert_array_equal(hi.numpy(), j_hi.astype(np.int64))
    padded = ids.copy()
    padded[:, 0] = -1  # a -1 pad: w + 1 wraps to 0 in u32, as the JAX device computes
    lo, hi = th.kenlm_chain_t(torch.as_tensor(padded))
    w_lo, w_hi = jh.kenlm_chain(jnp, jnp.asarray(padded.astype(np.int32)))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(w_lo).astype(np.int64))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(w_hi).astype(np.int64))
    seeds = [0, th.KENLM_BASE_SEED, 0xFFFFFFFF]
    for seed in seeds:
        got = th.mix32_pair_t(lo, hi, seed).numpy()
        np.testing.assert_array_equal(got, jh.mix32_pair(np, np.asarray(w_lo), np.asarray(w_hi), np.uint32(seed)))
    for word in ("", "a", "bunny", "sunnyside", "ünïcode", "<unk>", "x" * 17):
        assert th.murmur64(word.encode("utf-8")) == jh.murmur64(word.encode("utf-8"))


# ---- readers and writer -------------------------------------------------------
@pytest.mark.parametrize("fmt", FORMATS)
def test_readers_match_jax(parity, fmt):
    path = parity[fmt]
    got, want = tkb.read_kenlm_binary(path), jkb.read_kenlm_binary(path)
    assert got.order == want.order == 3
    assert got.vocab == want.vocab and got.unk_id == want.unk_id == 0
    assert got.uni.tobytes() == want.uni.tobytes()
    assert len(got.raw) == len(want.raw) == 2
    for (gk, gp, gb), (wk, wp, wb) in zip(got.raw, want.raw):
        np.testing.assert_array_equal(gk, wk)
        np.testing.assert_array_equal(gp, wp)
        np.testing.assert_array_equal(gb, wb)
    t_model, j_model = tkb.KenLMBinaryModel(got), jkb.KenLMBinaryModel(want)
    assert t_model.vocab_words() == j_model.vocab_words()
    words = t_model.vocab_words()[1:] + ["never-seen"]
    rng = np.random.RandomState(len(fmt))
    for _ in range(50):
        t_state, j_state = t_model.begin_sentence_state(), j_model.begin_sentence_state()
        assert t_state == j_state
        for word in rng.choice(words, size=6):
            t_score, t_state = t_model.raw_score_word(t_state, str(word))
            j_score, j_state = j_model.raw_score_word(j_state, str(word))
            assert (t_score, t_state) == (j_score, j_state)
        assert t_model.raw_end_score(t_state) == j_model.raw_end_score(j_state)


def test_probing_writer_bytes_equal_jax(parity, files, tmp_path):
    """The port's PROBING writer (its probing insert is vectorized) writes the JAX writer's bytes."""
    for name, tables in (("parity", parity["tables"]), ("inline", read_arpa(files["arpa"])),
                         ("inline 2-gram", read_arpa(files["arpa2"]))):
        for mult in (1.5, 1.0):  # 1.0: the fewest buckets, long probe runs that wrap at the end
            ours, theirs = str(tmp_path / "ours.bin"), str(tmp_path / "theirs.bin")
            tkb.write_kenlm_binary(tables, ours, probing_multiplier=mult)
            jkb.write_kenlm_binary(tables, theirs, probing_multiplier=mult)
            with open(ours, "rb") as a, open(theirs, "rb") as b:
                assert a.read() == b.read(), (name, mult)


def test_open_ngram_file_dispatch_and_refusals(files, tmp_path):
    for fmt in FORMATS:
        model = open_ngram_file(files[fmt])
        assert type(model) is tkb.KenLMBinaryModel and model.order == 3
        assert model.path == files[fmt]
    for key in ("arpa", "ctclm"):
        assert type(open_ngram_file(files[key], backend="python")) is P.NGramModel
    # as the JAX package's: "auto" reads plain ARPA with the native engine, anything else in Python
    from pyctcdecode_torch.models.native import NativeNGramModel

    assert type(open_ngram_file(files["ctclm"])) is P.NGramModel
    assert type(open_ngram_file(files["arpa"])) is NativeNGramModel
    assert type(open_ngram_file(files["arpa"], backend="native")) is NativeNGramModel
    with pytest.raises(ValueError, match="plain-text ARPA"):
        open_ngram_file(files["ctclm"], backend="native")
    with pytest.raises(ValueError, match="backend"):
        open_ngram_file(files["arpa"], backend="kenlm")
    with open(files["probing"], "rb") as fh:
        raw = bytearray(fh.read())
    for name, offset, value, message in (
        ("array_trie.bin", 96, 4, "ARRAY_TRIE"),  # model_type (i32 at params + 8)
        ("no_vocab.bin", 100, 0, "without vocabulary strings"),  # has_vocab (u8 at params + 12)
    ):
        bad = bytearray(raw)
        bad[offset] = value
        path = str(tmp_path / name)
        with open(path, "wb") as fh:
            fh.write(bytes(bad))
        for opener in (open_ngram_file, j_open_ngram_file):
            with pytest.raises(ValueError, match=message):
                opener(path)
    not_ctclm = str(tmp_path / "model.ctclm")
    with open(not_ctclm, "wb") as fh:
        fh.write(b"\0" * 16)
    with pytest.raises(ValueError, match="compiled LM"):
        open_ngram_file(not_ctclm)


# ---- device tables --------------------------------------------------------------
def _device_lms(path, labels=SAMPLE_LABELS, unigrams=UNIGRAMS):
    jlm = JLanguageModel(j_open_ngram_file(path), unigrams)
    tlm = P.LanguageModel(open_ngram_file(path), unigrams)
    return (jdt.build_device_lm(jlm, j_tokens(JAlphabet.build_alphabet(labels))),
            tdt.build_device_lm(tlm, t_tokens(P.Alphabet.build_alphabet(labels))))


def _same_placement(jt, tt):
    """Two KenLM-keyed tables with the same buckets, slots, seeds and values (the lanes may differ)."""
    assert (jt.n, jt.size, jt.seed_lo, jt.seed_hi, jt.count) == (tt.n, tt.size, tt.seed_lo, tt.seed_hi, tt.count)
    s, w = tdt._BUCKET_SLOTS, tdt._SUB_WIDTH
    jb, tb = jt.bucket.view(np.uint32), tt.bucket.view(np.uint32)
    for sub in range(jb.shape[1] // w):
        lo = slice(sub * w, sub * w + s)
        np.testing.assert_array_equal(jb[:, lo] == 0xFFFFFFFF, tb[:, lo] == 0xFFFFFFFF)  # occupied slots
        np.testing.assert_array_equal(jb[:, sub * w + 2 * s:(sub + 1) * w], tb[:, sub * w + 2 * s:(sub + 1) * w])


@pytest.mark.parametrize("fmt", FORMATS)
def test_kenlm_device_tables_match_jax(parity, fmt):
    """The KenLM branch of ``build_device_lm`` against JAX's: the same DeviceLM but for the lanes.

    ``build_fp_table_from_hashes`` keeps JAX's base slot (so its sizes,
    seeds, slots and values) and derives each fingerprint lane from one half
    of the chain (``hash_mode="kenlm64"``). ``DeviceLM.from_numpy`` carries
    the port's own tables across and refuses JAX's (``"kenlm"``).
    """
    labels = [" "] + list("abcdefghijklmnopqrstuvwxyz") + ["'", ""]
    unigrams = sorted(load_unigram_set_from_arpa(parity["arpa"]))
    jdlm, tdlm = _device_lms(parity[fmt], labels, unigrams)
    for name in ("order", "unk_id", "eos_id", "unk_prob10", "start_ctx_len", "has_unigrams"):
        assert getattr(jdlm, name) == getattr(tdlm, name), name
    for name in ("start_ctx", "start_ctx_backoffs", "uni", "seed_node"):
        np.testing.assert_array_equal(getattr(jdlm, name), getattr(tdlm, name), err_msg=name)
    for name in ("next", "word_id", "is_uni_word", "is_uni_prefix", "min_completion"):
        np.testing.assert_array_equal(getattr(jdlm.trie, name), getattr(tdlm.trie, name), err_msg=name)
    for jt, tt in zip(jdlm.fp_tables, tdlm.fp_tables):
        assert (jt.hash_mode, tt.hash_mode) == ("kenlm", "kenlm64")
        _same_placement(jt, tt)
    fields = dict(order=tdlm.order, unk_id=tdlm.unk_id, eos_id=tdlm.eos_id, unk_prob10=tdlm.unk_prob10,
                  start_ctx=tdlm.start_ctx, start_ctx_len=tdlm.start_ctx_len,
                  start_ctx_backoffs=tdlm.start_ctx_backoffs, uni=tdlm.uni, trie=vars(tdlm.trie),
                  seed_node=tdlm.seed_node, has_unigrams=tdlm.has_unigrams)
    again = tdt.DeviceLM.from_numpy(fp_tables=[vars(t) for t in tdlm.fp_tables], **fields)
    for tt, ta in zip(tdlm.fp_tables, again.fp_tables):
        assert vars(ta).keys() == vars(tt).keys()
        for key, val in vars(tt).items():
            np.testing.assert_array_equal(getattr(ta, key), val, err_msg=key)
    assert [t["hash_mode"] for t in again.as_device("cpu")["fp"]] == ["kenlm64", "kenlm64"]
    with pytest.raises(ValueError, match="32-bit fold"):
        tdt.DeviceLM.from_numpy(fp_tables=[vars(t) for t in jdlm.fp_tables], **fields)
    # a chain hash stored twice keeps its first occurrence, as JAX's build does
    keys, probs, backoffs = tkb.read_kenlm_binary(parity[fmt]).raw[0]
    dup = np.concatenate([keys, keys[:5]]), np.concatenate([probs, probs[5:10]]), \
        np.concatenate([backoffs, backoffs[5:10]])
    _same_placement(jdt.build_fp_table_from_hashes(*dup, 2), tdt.build_fp_table_from_hashes(*dup, 2))


def test_kenlm_lanes_keep_all_64_bits():
    """Keys that share ``lo ^ hi * 0x85EBCA6B`` (one pair a 2**32 key space holds ~n**2 / 2**33 of).

    The JAX reference derives base slot and both lanes from that one 32-bit
    value: no reseed separates the two keys and its build gives up. The
    port's lanes are one half each: the table builds, and each key reads
    its own value, by the numpy probe and by the plain ``probe_rows``.
    """
    c = 0x85EBCA6B
    rng = np.random.RandomState(9)
    keys = []
    for _ in range(3):
        lo1, hi1, hi2 = (int(v) for v in rng.randint(1, 1 << 31, size=3))
        lo2 = lo1 ^ ((hi1 * c) & 0xFFFFFFFF) ^ ((hi2 * c) & 0xFFFFFFFF)
        keys += [lo1 | (hi1 << 32), lo2 | (hi2 << 32)]
    keys = np.array(keys, dtype=np.uint64)
    probs = -np.arange(1, 7, dtype=np.float32) / 10
    with pytest.raises(ValueError, match="collision-free"):
        jdt.build_fp_table_from_hashes(keys, probs, probs * 2, 2)
    tab = tdt.build_fp_table_from_hashes(keys, probs, probs * 2, 2)
    lo32 = torch.as_tensor((keys & np.uint64(0xFFFFFFFF)).astype(np.int64))
    hi32 = torch.as_tensor((keys >> np.uint64(32)).astype(np.int64))
    base = th.mix32_pair_t(lo32, hi32, th.KENLM_BASE_SEED)
    lanes = [th.mix32_pair_t(half, 0, seed).clamp(max=tg.FP_MAX)
             for half, seed in ((lo32, tab.seed_lo), (hi32, tab.seed_hi))]
    rows = torch.as_tensor(tab.bucket)[base % tab.size]
    found, prob, backoff = tg.bucket_readout(rows, *lanes, torch.ones(len(keys), dtype=torch.bool),
                                             tdt._BUCKET_SLOTS, tdt._SUB_WIDTH)
    assert bool(found.all())
    np.testing.assert_array_equal(prob.numpy(), probs)
    np.testing.assert_array_equal(backoff.numpy(), probs * 2)


def test_kenlm_probe_and_scorer_match_jax(parity):
    """``probe_rows_ref`` in KenLM mode (through ``lm_score_words``) against JAX's scorer, bit for bit."""
    labels = [" "] + list("abcdefghijklmnopqrstuvwxyz") + ["'", ""]
    jdlm, tdlm = _device_lms(parity["probing"], labels, sorted(load_unigram_set_from_arpa(parity["arpa"])))
    raw = tkb.read_kenlm_binary(parity["probing"])
    arpa = parity["tables"]
    id2word = {i: w for w, i in arpa.vocab.items()}
    rng = np.random.RandomState(3)
    # present trigrams (by word, in the binary's ids), then random rows with every context length
    present = [[raw.vocab[id2word[i]] for i in key] for key in list(arpa.ngrams[2])[:200]]
    full = np.concatenate([np.array(present), rng.randint(0, len(raw.vocab), size=(200, 3))]).astype(np.int64)
    ctx_len = np.concatenate([np.full(len(present), 2), rng.randint(0, 3, size=200)]).astype(np.int64)
    ctx = full[:, :2].copy()
    for row, n in zip(ctx, ctx_len):
        row[: 2 - n] = -1
    wid = full[:, -1]
    bo = np.stack([tdt.context_suffix_backoffs(tdlm, ctx[i, 2 - ctx_len[i]:]) for i in range(len(ctx))])
    jbo = np.stack([jdt.context_suffix_backoffs(jdlm, ctx[i, 2 - ctx_len[i]:]) for i in range(len(ctx))])
    np.testing.assert_array_equal(bo, jbo)
    jdev = dict(jdlm.as_device())
    jdev["fp"] = [dict(tab, hash_mode=t.hash_mode) for tab, t in zip(jdev["fp"], jdlm.fp_tables)]
    want = jdt.lm_score_words_jnp(
        jdev, jdlm.order, np.float32(jdlm.unk_prob10), jnp.asarray(ctx.astype(np.int32)),
        jnp.asarray(ctx_len.astype(np.int32)), jnp.asarray(wid.astype(np.int32)), jnp.asarray(bo),
    )
    tdev = tdlm.as_device("cpu")
    got = tdt.lm_score_words(tdev, torch.as_tensor(ctx), torch.as_tensor(ctx_len), torch.as_tensor(wid),
                             torch.as_tensor(bo))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(g.numpy().dtype))
    found = tg.probe_rows_ref(torch.as_tensor(np.concatenate([ctx, wid[:, None]], 1)), torch.as_tensor(ctx_len),
                              tdev["fp"], tdt._BUCKET_SLOTS, tdt._SUB_WIDTH)[0]
    assert bool(found[1][: len(present)].all())  # the present trigrams are found
    with pytest.raises(ValueError, match="hash_mode"):
        tg.query_hashes(dict(tdev["fp"][0], hash_mode="murmur"), torch.as_tensor(full[:, 1:]))


# ---- decodes ---------------------------------------------------------------------
@pytest.fixture(scope="module")
def decoders(files):
    """(JAX, torch) device decoders by model file, built on first use."""
    cache = {}

    def get(key):
        if key not in cache:
            if key == "mixed":  # member A an ARPA 2-gram, member B the PROBING 3-gram
                jlm = JMultiLanguageModel([JLanguageModel(j_open_ngram_file(files["arpa2"]), UNIGRAMS),
                                           JLanguageModel(j_open_ngram_file(files["probing"]), UNIGRAMS,
                                                          **MEMBER_B)])
                plm = P.MultiLanguageModel([P.LanguageModel(open_ngram_file(files["arpa2"]), UNIGRAMS),
                                            P.LanguageModel(open_ngram_file(files["probing"]), UNIGRAMS,
                                                            **MEMBER_B)])
            else:
                jlm = JLanguageModel(j_open_ngram_file(files[key]), UNIGRAMS)
                plm = P.LanguageModel(open_ngram_file(files[key]), UNIGRAMS)
            cache[key] = (TPUBeamSearchDecoderCTC(JAlphabet.build_alphabet(SAMPLE_LABELS), jlm),
                          P.TorchBeamSearchDecoderCTC(P.Alphabet.build_alphabet(SAMPLE_LABELS), plm, device="cpu"))
        return cache[key]

    return get


BATCH = [word_logits(20, 30), word_logits(21, 18), word_logits(22, 36)]


@pytest.mark.parametrize("key,serving", [("probing", False), ("probing", True), ("trie", False),
                                         ("quant_trie", False), ("ctclm", False), ("mixed", False)])
def test_device_decode_from_a_binary_matches_jax(decoders, key, serving):
    jdec, pdec = decoders(key)
    kw = dict(beam_width=12, prune_history=True, top_n=3)
    if serving:
        kw.update(token_chunking=3, blank_collapse=True, length_bucketing=2)
    jres, pres = jdec.decode_beams_batch(BATCH, **kw), pdec.decode_beams_batch(BATCH, **kw)
    for jb, pb in zip(jres, pres):
        assert_same_beams(jb, pb)
    if key in FORMATS:
        assert [t["hash_mode"] for t in pdec._tabs["lms"][0]["fp"]] == ["kenlm64", "kenlm64"]
        assert pdec.decode(TEST_LOGITS, beam_width=8) == "bugs bunny"


def test_stream_from_a_binary_matches_jax(decoders):
    jdec, pdec = decoders("probing")
    mat = word_logits(23, 40)
    chunks = [mat[:13], mat[13:27], mat[27:]]
    js, ps = jdec.get_starting_state(beam_width=12), pdec.get_starting_state(beam_width=12)
    for i, chunk in enumerate(chunks):
        kw = dict(force_next_word=(i == 1), is_end=(i == len(chunks) - 1))
        assert_same_views(jdec.partial_decode_beams(js, chunk, **kw), pdec.partial_decode_beams(ps, chunk, **kw))


@pytest.mark.parametrize("fmt", FORMATS)
def test_host_oracle_from_a_binary_matches_jax(files, fmt):
    jlm = JLanguageModel(j_open_ngram_file(files[fmt]), UNIGRAMS)
    plm = P.LanguageModel(open_ngram_file(files[fmt]), UNIGRAMS)
    jdec = JBeamSearchDecoderCTC(JAlphabet.build_alphabet(SAMPLE_LABELS), jlm)
    pdec = P.BeamSearchDecoderCTC(P.Alphabet.build_alphabet(SAMPLE_LABELS), plm)
    for mat in BATCH + [np.asarray(TEST_LOGITS)]:
        want, got = jdec.decode_beams(mat, beam_width=12), pdec.decode_beams(mat, beam_width=12)
        assert len(got) == len(want) > 0
        for wb, gb in zip(want, got):
            assert (gb.text, gb.text_frames, gb.logit_score, gb.lm_score) == (
                wb.text, wb.text_frames, wb.logit_score, wb.lm_score)
            assert gb.last_lm_state.context == wb.last_lm_state.context
    assert pdec.decode(TEST_LOGITS) == "bugs bunny"
    jdec.cleanup()
    pdec.cleanup()


def test_build_ctcdecoder_reads_unigrams_from_a_binary(files, caplog):
    """Without ``unigrams`` a binary or ``.ctclm`` gives its vocabulary (``<...>`` tokens left out)."""
    arpa_words = P.build_ctcdecoder(SAMPLE_LABELS, files["arpa"], device="cpu").language_model.unigram_set
    want = {w for w in arpa_words if not (w.startswith("<") and w.endswith(">"))}
    assert want == set(UNIGRAMS + ["guns"])
    for key in ("probing", "quant_trie", "ctclm"):
        dec = P.build_ctcdecoder(SAMPLE_LABELS, files[key], device="cpu")
        assert dec.language_model.unigram_set == want
        assert dec.decode(TEST_LOGITS, beam_width=8) == "bugs bunny"
    host = P.build_ctcdecoder(SAMPLE_LABELS, files["probing"], engine="host")
    assert host.decode(TEST_LOGITS) == "bugs bunny"
    host.cleanup()
