"""Port device tables vs the JAX package's, on one small synthetic 3-gram.

* the port's numpy builders give bit-equal planes (fingerprint buckets,
  seeds, unigrams, trie arrays, the packed trie plane, start context);
* ``DeviceLM.from_numpy`` round-trips the JAX package's tables;
* the torch probes (``probe_fp``, ``lm_score_words``, ``trie_fetch_rows``)
  equal the JAX ``jnp`` functions on the same tables and queries;
* for every alphabet that cannot spell the LM's ``<s>`` / ``</s>`` (QuartzNet's
  labels, the benchmark's 128 BPE pieces, the test alphabets) the tables are
  JAX's, array for array; wav2vec2's labels spell them, and there the port's
  trie gives the two markers their word ids where JAX's leaves them out.
"""
import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyctcdecode_torch.alphabet import Alphabet as TAlphabet
from pyctcdecode_torch.evaluation import make_parity_arpa
from pyctcdecode_torch.models import device_tables as tdt
from pyctcdecode_torch.models.language_model import LanguageModel as TLanguageModel
from pyctcdecode_torch.models.ngram import load_unigram_set_from_arpa as t_unigrams
from pyctcdecode_torch.models.ngram import open_ngram_file
from pyctcdecode_torch.ops.tokens import build_token_arrays as t_tokens
from pyctcdecode_tpu.alphabet import Alphabet as JAlphabet
from pyctcdecode_tpu.models import device_tables as jdt
from pyctcdecode_tpu.models.language_model import LanguageModel as JLanguageModel
from pyctcdecode_tpu.models.ngram import NGramModel as JNGramModel
from pyctcdecode_tpu.ops.tokens import build_token_arrays as j_tokens

from .helpers import SAMPLE_LABELS
from .torch_cases import BPE_LABELS, LM_WORDS, piece_vocabulary
from .torch_cases import one_torch_thread  # noqa: F401  (autouse fixture)

LABELS = [" "] + list("abcdefghijklmnopqrstuvwxyz") + ["'", ""]
W2V2_LABELS = ["<pad>", "<s>", "</s>", "<unk>", "|", "e", "t", "a", "o", "n", "i", "h", "s", "r", "d", "l",
               "u", "m", "w", "c", "f", "g", "y", "p", "b", "v", "k", "'", "x", "j", "q", "z"]


def _config_labels(name):
    path = os.path.join(os.path.dirname(os.path.dirname(__file__)), "cardbench", "configs", f"{name}.json")
    with open(path, encoding="utf-8") as fh:
        return json.load(fh)["labels"]


# alphabets that cannot spell <s> / </s>: the tables must stay the JAX package's
UNSPELLED = {
    "quartznet": _config_labels("quartznet-char-3gram"),
    "bpe128": _config_labels("conformer-bpe128-3gram"),
    "sample": SAMPLE_LABELS,
    "bpe": BPE_LABELS,
    "pieces": piece_vocabulary(LM_WORDS),
}


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("lm") / "small3.arpa")
    make_parity_arpa(path, n_vocab=400, n_bigrams=3000, n_trigrams=2000)
    unigrams = sorted(t_unigrams(path))
    jlm = JLanguageModel(JNGramModel.from_file(path), unigrams)
    tlm = TLanguageModel(open_ngram_file(path, backend="python"), unigrams)
    jdlm = jdt.build_device_lm(jlm, j_tokens(JAlphabet.build_alphabet(LABELS)))
    tdlm = tdt.build_device_lm(tlm, t_tokens(TAlphabet.build_alphabet(LABELS)))
    present = [np.array(list(d.keys()), dtype=np.int32) for d in tlm.ngram_model.tables.ngrams]
    return jdlm, tdlm, present


def jax_fields(jdlm):
    """The JAX DeviceLM's numpy fields, as DeviceLM.from_numpy takes them."""
    return dict(
        order=jdlm.order,
        unk_id=jdlm.unk_id,
        eos_id=jdlm.eos_id,
        unk_prob10=jdlm.unk_prob10,
        start_ctx=jdlm.start_ctx,
        start_ctx_len=jdlm.start_ctx_len,
        start_ctx_backoffs=jdlm.start_ctx_backoffs,
        uni=jdlm.uni,
        fp_tables=[dataclasses.asdict(t) for t in jdlm.fp_tables],
        trie=dataclasses.asdict(jdlm.trie),
        seed_node=jdlm.seed_node,
        has_unigrams=jdlm.has_unigrams,
    )


def _assert_same_lm(jdlm, tdlm):
    for name in ("order", "unk_id", "eos_id", "unk_prob10", "start_ctx_len", "has_unigrams"):
        assert getattr(jdlm, name) == getattr(tdlm, name), name
    for name in ("start_ctx", "start_ctx_backoffs", "uni", "seed_node"):
        np.testing.assert_array_equal(getattr(jdlm, name), getattr(tdlm, name), err_msg=name)
    assert len(jdlm.fp_tables) == len(tdlm.fp_tables)
    for jt, tt in zip(jdlm.fp_tables, tdlm.fp_tables):
        assert (jt.n, jt.size, jt.seed_lo, jt.seed_hi, jt.hash_mode) == (
            tt.n, tt.size, tt.seed_lo, tt.seed_hi, tt.hash_mode
        )
        np.testing.assert_array_equal(jt.bucket, tt.bucket)
    for name in ("next", "word_id", "is_uni_word", "is_uni_prefix", "min_completion"):
        np.testing.assert_array_equal(getattr(jdlm.trie, name), getattr(tdlm.trie, name), err_msg=name)
    assert jdlm.trie.dead == tdlm.trie.dead
    assert jdlm.trie_pack == tdlm.trie_pack


def test_built_planes_bit_equal(tables):
    jdlm, tdlm, _ = tables
    _assert_same_lm(jdlm, tdlm)
    jplane = np.asarray(jdlm.as_device()["trie_rows"])
    np.testing.assert_array_equal(jplane, tdlm.trie_plane())
    np.testing.assert_array_equal(
        np.asarray(jdlm.as_device()["seed_node"]), tdlm.seed_entries()
    )


def test_from_numpy_round_trips(tables):
    jdlm, tdlm, _ = tables
    rebuilt = tdt.DeviceLM.from_numpy(**jax_fields(jdlm))
    _assert_same_lm(jdlm, rebuilt)
    a, b = rebuilt.as_device("cpu"), tdlm.as_device("cpu")
    for name in ("uni", "trie_rows", "trie_word_id", "uni_unk_row", "seed_node"):
        assert torch.equal(a[name], b[name]), name
    for ta, tb in zip(a["fp"], b["fp"]):
        assert torch.equal(ta["bucket"], tb["bucket"])
        assert (ta["seed_lo"], ta["seed_hi"], ta["size"]) == (tb["seed_lo"], tb["seed_hi"], tb["size"])


@pytest.fixture(scope="module")
def lms(tmp_path_factory):
    """The JAX and the port LanguageModel over one small parity 3-gram (its <s> and </s> are unigram lines)."""
    path = str(tmp_path_factory.mktemp("lm") / "small3.arpa")
    make_parity_arpa(path, n_vocab=400, n_bigrams=3000, n_trigrams=2000)
    unigrams = sorted(t_unigrams(path))
    assert {"<s>", "</s>"} <= set(unigrams)
    return (JLanguageModel(JNGramModel.from_file(path), unigrams),
            TLanguageModel(open_ngram_file(path, backend="python"), unigrams))


def _both(lms, labels):
    jlm, tlm = lms
    return (jdt.build_device_lm(jlm, j_tokens(JAlphabet.build_alphabet(labels))),
            tdt.build_device_lm(tlm, t_tokens(TAlphabet.build_alphabet(labels))))


@pytest.mark.parametrize("name", sorted(UNSPELLED))
def test_alphabets_that_cannot_spell_the_markers_build_the_jax_tables(lms, name):
    jdlm, tdlm = _both(lms, UNSPELLED[name])
    _assert_same_lm(jdlm, tdlm)
    np.testing.assert_array_equal(np.asarray(jdlm.as_device()["trie_rows"]), tdlm.trie_plane())
    assert not np.isin(tdlm.trie.word_id, [lms[1].ngram_model.tables.vocab[w] for w in ("<s>", "</s>")]).any()


def test_wav2vec2_labels_give_the_markers_their_word_ids(lms):
    """The one difference from JAX's tables: the word ids at the ``<s>`` and ``</s>`` nodes (and their plane cells)."""
    jdlm, tdlm = _both(lms, W2V2_LABELS)
    vocab = lms[1].ngram_model.tables.vocab
    differ = np.flatnonzero(jdlm.trie.word_id != tdlm.trie.word_id)
    assert sorted(tdlm.trie.word_id[differ]) == sorted([vocab["<s>"], vocab["</s>"]])
    assert (jdlm.trie.word_id[differ] == -1).all()
    planes = np.asarray(jdlm.as_device()["trie_rows"]), tdlm.trie_plane()
    # a marker's node slot (word id, unigram score, backoff, flag) and its parent's cell of the char
    assert 0 < int((planes[0] != planes[1]).sum()) <= 5 * len(differ)
    jdlm.trie.word_id = tdlm.trie.word_id
    _assert_same_lm(jdlm, tdlm)


def _queries(tdlm, rng, q, n):
    """Random id keys, a quarter of them led by the -1 context pad."""
    vocab = tdlm.uni.shape[0]
    keys = rng.randint(0, vocab, size=(q, n)).astype(np.int32)
    keys[: q // 4, 0] = -1
    return keys


def test_probe_fp_matches_jax(tables):
    jdlm, tdlm, present = tables
    rng = np.random.RandomState(0)
    jdev = jdlm.as_device()
    tdev = tdlm.as_device("cpu")
    for order_idx, table in enumerate(tdlm.fp_tables):
        n = table.n
        hits = present[n - 1][rng.permutation(len(present[n - 1]))[:150]]
        keys = np.concatenate([_queries(tdlm, rng, 200, n), hits], axis=0)
        valid = rng.rand(keys.shape[0]) < 0.9
        jtab = dict(jdev["fp"][order_idx], hash_mode="fnv")
        jf, jp, jb = jdt.probe_fp_jnp(jtab, jnp.asarray(keys), jnp.asarray(valid))
        tf, tp, tb = tdt.probe_fp(tdev["fp"][order_idx], torch.as_tensor(keys), torch.as_tensor(valid))
        np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
        assert tf.numpy()[200:].sum() >= 100  # the present keys hit


def test_lm_score_words_matches_jax(tables):
    jdlm, tdlm, _ = tables
    rng = np.random.RandomState(1)
    q = 300
    order = tdlm.order
    width = order - 1
    vocab = tdlm.uni.shape[0]
    ctx_len = rng.randint(0, width + 1, size=q).astype(np.int32)
    ctx = rng.randint(0, vocab, size=(q, width)).astype(np.int32)
    for i in range(q):
        ctx[i, : width - ctx_len[i]] = -1
    bo = np.stack([tdt.context_suffix_backoffs(tdlm, ctx[i, width - ctx_len[i]:]) for i in range(q)])
    wid = rng.randint(0, vocab, size=q).astype(np.int32)
    jdev = dict(jdlm.as_device())
    jdev["fp"] = [dict(t, hash_mode="fnv") for t in jdev["fp"]]
    want = jdt.lm_score_words_jnp(
        jdev, order, np.float32(jdlm.unk_prob10), jnp.asarray(ctx), jnp.asarray(ctx_len),
        jnp.asarray(wid), jnp.asarray(bo),
    )
    got = tdt.lm_score_words(
        tdlm.as_device("cpu"), torch.as_tensor(ctx).long(), torch.as_tensor(ctx_len).long(),
        torch.as_tensor(wid), torch.as_tensor(bo),
    )
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(g.numpy().dtype))


def test_trie_fetch_rows_matches_jax(tables):
    jdlm, tdlm, _ = tables
    rng = np.random.RandomState(2)
    nodes = rng.randint(0, tdlm.trie.n_nodes, size=(7, 13)).astype(np.int32)
    jrows = jdlm.as_device()["trie_rows"]
    want = jdt.trie_fetch_rows(jnp, jrows, jdlm.trie_pack, jnp.asarray(nodes))
    tdev = tdlm.as_device("cpu")
    got = tdt.trie_fetch_rows(tdev["trie_rows"], tdev["trie_pack"], torch.as_tensor(nodes))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_only_arpa_models_load(tmp_path):
    """KenLM binaries load (a PROBING one the JAX package wrote), and so does ARPA through the native loader."""
    from pyctcdecode_torch.models.kenlm_bin import KenLMBinaryModel
    from pyctcdecode_tpu.models.kenlm_bin import write_kenlm_binary
    from pyctcdecode_tpu.models.ngram import read_arpa

    arpa = os.path.join(tmp_path, "small3.arpa")
    make_parity_arpa(arpa, n_vocab=400, n_bigrams=3000, n_trigrams=2000)
    path = os.path.join(tmp_path, "model.bin")
    write_kenlm_binary(read_arpa(arpa), path)
    model = open_ngram_file(path)
    assert isinstance(model, KenLMBinaryModel) and model.order == 3
    tlm = TLanguageModel(model, sorted(t_unigrams(arpa)))
    dlm = tdt.build_device_lm(tlm, t_tokens(TAlphabet.build_alphabet(LABELS)))
    assert [t.hash_mode for t in dlm.fp_tables] == ["kenlm64", "kenlm64"]
    from pyctcdecode_torch.models.native import NativeNGramModel

    native = open_ngram_file(arpa, backend="native")
    assert isinstance(native, NativeNGramModel) and native.order == 3
    with pytest.raises(ValueError, match="plain-text ARPA"):
        open_ngram_file(os.path.join(tmp_path, "model.ctclm"), backend="native")
