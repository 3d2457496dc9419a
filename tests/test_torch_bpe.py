"""BPE and multi-character labels on the port's dense decode, held against the JAX package.

``TorchBeamSearchDecoderCTC(device="cpu")`` against the JAX
``TPUBeamSearchDecoderCTC`` on the same alphabet, the same inline ARPA and the
same logits made with numpy from seeds: texts, ``text_frames`` and
``last_lm_state`` identical, scores within 1e-4 (both engines score in
float32). Alphabets: the JAX package's own BPE alphabet, the same pieces
written ``##``-style, a char alphabet with a two-character label, and a
48-column piece vocabulary grown from the ARPA's words (labels up to 5
characters). The unknown piece ``▁⁇▁`` is bounded on the right, so the token
after it starts a word even when it is a plain piece: the cases put it
mid-utterance.

The JAX engine compiles one program per shape, so the cases share a few beam
widths and frame counts.
"""
import numpy as np
import pytest

import pyctcdecode_torch as P
from pyctcdecode_torch.models import device_tables as tdt
from pyctcdecode_torch.models.ngram import open_ngram_file
from pyctcdecode_torch.ops.tokens import build_token_arrays
from pyctcdecode_tpu import Alphabet as JAlphabet
from pyctcdecode_tpu import LanguageModel as JLanguageModel
from pyctcdecode_tpu import TPUBeamSearchDecoderCTC
from pyctcdecode_tpu.models import device_tables as jdt
from pyctcdecode_tpu.models.ngram import NGramModel as JNGramModel
from pyctcdecode_tpu.ops.tokens import build_token_arrays as jbuild_token_arrays

from .torch_cases import (
    ARPA,
    BPE_LABELS,
    LM_WORDS,
    UNIGRAMS,
    assert_same_beams,
    conformer_width,
    one_hot,
    piece_logits,
    piece_vocabulary,
)
from .torch_cases import one_torch_thread  # noqa: F401  (autouse fixture)

PIECES = piece_vocabulary(LM_WORDS)
WIDE = conformer_width(PIECES)
# the JAX package's BPE alphabet written with ``##`` continuation marks
HASH_LABELS = ["bug", "bun", "##ny", "##s", "##g", "##un", "<unk>", ""]
# a char alphabet whose "un" label is two characters long
MULTI_CHAR_LABELS = [" ", "b", "g", "n", "s", "u", "y", "un", ""]
SETTINGS = {"default": {}, "other": dict(alpha=0.9, beta=0.3, unk_score_offset=-4.0)}


@pytest.fixture(scope="module")
def arpa_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("lm") / "bb3.arpa")
    with open(path, "w") as fh:
        fh.write(ARPA)
    return path


@pytest.fixture(scope="module")
def decoders(arpa_path):
    """(JAX, torch) decoder pairs, keyed by (alphabet, LM setting); built on first use."""
    cache = {}
    labels = {"bpe": BPE_LABELS, "hash": HASH_LABELS, "multi": MULTI_CHAR_LABELS, "pieces": PIECES,
              "wide": WIDE}

    def get(alphabet, lm="default"):
        if (alphabet, lm) not in cache:
            ja = JAlphabet.build_alphabet(labels[alphabet])
            pa = P.Alphabet.build_alphabet(labels[alphabet])
            if lm == "none":
                jlm = plm = None
            else:
                jlm = JLanguageModel(JNGramModel.from_file(arpa_path), UNIGRAMS, **SETTINGS[lm])
                plm = P.LanguageModel(open_ngram_file(arpa_path), UNIGRAMS, **SETTINGS[lm])
            cache[(alphabet, lm)] = (
                TPUBeamSearchDecoderCTC(ja, jlm), P.TorchBeamSearchDecoderCTC(pa, plm, device="cpu")
            )
        return cache[(alphabet, lm)]

    return get


def _labels(dec):
    return dec._alphabet.labels


@pytest.mark.parametrize("lm", ["none", "default"])
def test_one_hot_bugs_bunny(decoders, lm):
    """The JAX package's BPE engine case: one frame per piece spells "bugs bunny"."""
    jdec_, pdec = decoders("bpe", lm)
    mat = one_hot(_labels(pdec), ["▁bug", "s", "", "▁bun", "ny"])
    jb, pb = jdec_.decode_beams(mat, beam_width=8), pdec.decode_beams(mat, beam_width=8)
    assert pb[0].text == "bugs bunny"
    assert pb[0].text_frames == [("bugs", (0, 2)), ("bunny", (3, 5))]
    assert_same_beams(jb, pb)


@pytest.mark.parametrize("seed", range(8))
def test_random_matrices_match_jax(decoders, seed):
    """The JAX package's BPE fuzz: random logits at beam 6, the top 3 beams."""
    jdec_, pdec = decoders("bpe", "none" if seed % 2 else "default")
    rng = np.random.RandomState(13 + seed)
    mat = rng.randn(rng.randint(1, 30), len(BPE_LABELS)) * 2.0
    kw = dict(beam_width=6, top_n=3)
    assert_same_beams(jdec_.decode_beams(mat, **kw), pdec.decode_beams(mat, **kw))


@pytest.mark.parametrize("lm", ["none", "default"])
def test_forced_break_mid_utterance(decoders, lm):
    """After ``▁⁇▁`` the plain piece "g" starts the word "guns" (without the break it would extend ``⁇``)."""
    jdec_, pdec = decoders("bpe", lm)
    mat = one_hot(_labels(pdec), ["▁bug", "s", "▁⁇▁", "g", "un", "s", "", "▁bun", "ny"])
    jb, pb = jdec_.decode_beams(mat, beam_width=8), pdec.decode_beams(mat, beam_width=8)
    assert pb[0].text == "bugs ⁇ guns bunny"
    assert_same_beams(jb, pb)


def test_hash_style_alphabet_is_the_piece_alphabet(decoders):
    """``##`` labels convert to ``▁`` labels, ``<unk>`` to ``▁⁇▁``; decodes agree."""
    jdec_, pdec = decoders("hash")
    assert _labels(pdec) == _labels(jdec_) == BPE_LABELS
    assert pdec._alphabet.is_bpe
    rng = np.random.RandomState(5)
    mat = rng.randn(23, len(BPE_LABELS)) * 2.0
    assert_same_beams(jdec_.decode_beams(mat, beam_width=6), pdec.decode_beams(mat, beam_width=6))


@pytest.mark.parametrize("seed,prune_history", [(0, False), (1, True)])
def test_multi_char_label_in_a_char_alphabet(decoders, seed, prune_history):
    """Not BPE, but the "un" label walks two characters (``lmax`` 2)."""
    jdec_, pdec = decoders("multi")
    tokens = build_token_arrays(pdec._alphabet)
    assert not pdec._alphabet.is_bpe and tokens.raw_chars.shape[1] == 2
    rng = np.random.RandomState(40 + seed)
    path = rng.choice([1, 2, 3, 4, 5, 6, 7, 7, 0, 8, 8], size=33)
    mat = rng.randn(33, len(MULTI_CHAR_LABELS)).astype(np.float32) * 1.3
    mat[np.arange(33), path] += 3.0
    kw = dict(beam_width=10, prune_history=prune_history, top_n=4)
    assert_same_beams(jdec_.decode_beams(mat, **kw), pdec.decode_beams(mat, **kw))


@pytest.mark.parametrize(
    "lm,k,prune_history,top_n,seed",
    [
        ("default", None, False, None, 0),
        ("default", 3, True, None, 1),
        ("default", "auto", False, 3, 2),
        ("other", None, True, 2, 3),
        ("other", "auto", True, None, 4),
        ("none", None, False, 4, 5),
    ],
)
def test_piece_vocabulary_matches_jax(decoders, lm, k, prune_history, top_n, seed):
    """48 columns, labels up to ``▁`` + 4 letters, ``▁⁇▁`` mid-utterance; beam 16."""
    jdec_, pdec = decoders("pieces", lm)
    assert build_token_arrays(pdec._alphabet).raw_chars.shape[1] == 5
    mat = piece_logits(seed, _labels(pdec), 6)
    assert mat.shape[0] <= 40
    kw = dict(beam_width=16, max_tokens_per_frame=k, prune_history=prune_history, top_n=top_n)
    assert_same_beams(jdec_.decode_beams(mat, **kw), pdec.decode_beams(mat, **kw))


@pytest.mark.parametrize("k,prune_history", [(None, True), ("auto", False)])
def test_conformer_width_vocabulary_matches_jax(decoders, k, prune_history):
    """V = 129: token ids and the blank above 120 (16-bit token paths in both engines)."""
    jdec_, pdec = decoders("wide")
    labels = _labels(pdec)
    assert len(labels) == 129 and labels.index("") == 128
    mat = piece_logits(12, labels, 5)
    assert labels.index(PIECES[2]) == 83  # every piece the logits spell sits past the filler
    kw = dict(beam_width=10, max_tokens_per_frame=k, prune_history=prune_history, top_n=3)
    assert_same_beams(jdec_.decode_beams(mat, **kw), pdec.decode_beams(mat, **kw))


@pytest.mark.parametrize("labels", [BPE_LABELS, PIECES, ["a", "b", ""]], ids=["bpe", "pieces", "char"])
def test_alphabet_coverage_check_matches_jax(labels, caplog):
    """The unigram coverage warning decides alike on piece labels."""
    from pyctcdecode_torch.alphabet import verify_alphabet_coverage
    from pyctcdecode_tpu.alphabet import verify_alphabet_coverage as jverify

    messages = []
    for build, verify in ((P.Alphabet.build_alphabet, verify_alphabet_coverage),
                          (JAlphabet.build_alphabet, jverify)):
        alphabet = build(labels)
        caplog.clear()
        with caplog.at_level("WARNING"):
            verify(alphabet, UNIGRAMS)
        messages.append([r.getMessage() for r in caplog.records if r.levelname == "WARNING"])
    assert messages[0] == messages[1]


def test_lm_start_state_chaining(decoders):
    jdec_, pdec = decoders("pieces")
    first, second = piece_logits(10, _labels(pdec), 5), piece_logits(11, _labels(pdec), 5, False)
    kw = dict(beam_width=16)
    jb, pb = jdec_.decode_beams(first, **kw), pdec.decode_beams(first, **kw)
    assert_same_beams(jb, pb)
    assert pb[0].last_lm_state.context
    assert_same_beams(
        jdec_.decode_beams(second, lm_start_state=jb[0].last_lm_state, **kw),
        pdec.decode_beams(second, lm_start_state=pb[0].last_lm_state, **kw),
    )
    assert pdec.decode(second, beam_width=16) == jdec_.decode(second, beam_width=16)


@pytest.mark.parametrize("labels", [BPE_LABELS, HASH_LABELS, MULTI_CHAR_LABELS, PIECES],
                         ids=["bpe", "hash", "multi", "pieces"])
def test_piece_tables_bit_equal(arpa_path, labels):
    """Token planes, the vocabulary trie's boundary seeds and the hot trie on pieces, against JAX."""
    ptok = build_token_arrays(P.Alphabet.build_alphabet(labels))
    jtok = jbuild_token_arrays(JAlphabet.build_alphabet(labels))
    for name in ("kind", "piece_chars", "piece_len", "raw_chars", "raw_len", "right_bound",
                 "seed_hash_lo", "seed_hash_hi"):
        np.testing.assert_array_equal(getattr(ptok, name), getattr(jtok, name), err_msg=name)
    assert ptok.char2id == jtok.char2id and ptok.is_bpe == jtok.is_bpe
    plm = P.LanguageModel(open_ngram_file(arpa_path), UNIGRAMS)
    jlm = JLanguageModel(JNGramModel.from_file(arpa_path), UNIGRAMS)
    pdlm, jdlm = tdt.build_device_lm(plm, ptok), jdt.build_device_lm(jlm, jtok)
    np.testing.assert_array_equal(pdlm.seed_entries(), np.asarray(jdlm.as_device()["seed_node"]))
    np.testing.assert_array_equal(pdlm.trie_plane(), np.asarray(jdlm.as_device()["trie_rows"]))
    hot = ["guns", "sunny", "bun"]
    got = tdt.build_hotword_tables(hot, ptok.char2id, ptok)
    want = jdt.build_hotword_tables(hot, jtok.char2id, jtok)
    for key in ("next", "seed"):
        np.testing.assert_array_equal(got[key], want[key])
    assert int(got["dead"]) == int(want["dead"])
