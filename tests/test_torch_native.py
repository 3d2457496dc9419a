"""The native (C++) ARPA loader in the port, against the JAX package's and the Python reader.

The port builds its own copy of ``ctclm.cpp`` with ``g++`` into ``build/``;
the JAX package builds its copy into its own directory. The two libraries'
answers (vocabulary, every order's exported entries, scores and outgoing
states) must be equal; the device tables built over the port's native model
must equal the JAX package's native branch plane for plane; decodes over a
natively read model must equal the decodes over the Python reader's
(texts, frames, LM states; scores to the bit: the same float32 values are
looked up). The JAX package's ``tests/test_native.py`` cases are mirrored on
inline and seeded models (its bugs/bunny fixture is absent here).
"""
import gzip
import os
import random
import shutil

import numpy as np
import pytest

import pyctcdecode_torch as P
from pyctcdecode_torch.csrc.native import NativeNGram, load_native
from pyctcdecode_torch.models import device_tables as tdt
from pyctcdecode_torch.models.native import NativeNGramModel
from pyctcdecode_torch.models.ngram import open_ngram_file
from pyctcdecode_torch.ops.tokens import build_token_arrays as t_tokens
from pyctcdecode_tpu import Alphabet as JAlphabet
from pyctcdecode_tpu import LanguageModel as JLanguageModel
from pyctcdecode_tpu.csrc import NativeNGram as JNativeNGram
from pyctcdecode_tpu.models import device_tables as jdt
from pyctcdecode_tpu.models.kenlm_bin import write_kenlm_binary
from pyctcdecode_tpu.models.native import NativeNGramModel as JNativeNGramModel
from pyctcdecode_tpu.models.native import open_ngram_file as j_open_ngram_file
from pyctcdecode_tpu.models.ngram import read_arpa
from pyctcdecode_tpu.ops.tokens import build_token_arrays as j_tokens

from .helpers import SAMPLE_LABELS, TEST_LOGITS
from .test_native import _random_arpa
from .torch_cases import ARPA, UNIGRAMS, assert_same_beams, word_logits
from .torch_cases import jax_native, one_torch_thread  # noqa: F401  (autouse fixtures)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The inline 3-gram as ARPA, gzipped ARPA, .ctclm and a KenLM binary; seeded random ARPAs of orders 3-5."""
    from pyctcdecode_tpu.models.binfmt import write_binary

    root = tmp_path_factory.mktemp("native")
    out = {"arpa": str(root / "bb3.arpa")}
    with open(out["arpa"], "w") as fh:
        fh.write(ARPA)
    out["gz"] = out["arpa"] + ".gz"
    with open(out["arpa"], "rb") as src, gzip.open(out["gz"], "wb") as dst:
        shutil.copyfileobj(src, dst)
    out["ctclm"] = str(root / "bb3.ctclm")
    write_binary(read_arpa(out["arpa"]), out["ctclm"])
    out["kenlm"] = str(root / "bb3.bin")
    write_kenlm_binary(read_arpa(out["arpa"]), out["kenlm"])
    for seed, order in ((1, 3), (3, 4), (4, 5)):
        out[f"r{seed}"] = str(root / f"r{seed}.arpa")
        _random_arpa(out[f"r{seed}"], seed, order=order)
    return out


def test_the_port_builds_its_own_library():
    from pyctcdecode_torch.csrc.build import BUILD_DIR, NATIVE_SOURCE, library_path

    assert load_native() is not None
    lib = library_path(NATIVE_SOURCE)
    assert lib.parent == BUILD_DIR and lib.exists()


@pytest.mark.parametrize("name", ["arpa", "r1", "r3", "r4"])
def test_tables_and_scores_equal_the_jax_packages_library(files, name):
    ours, theirs = NativeNGram(files[name]), JNativeNGram(files[name])
    for attr in ("order", "unk_id", "bos_id", "eos_id", "unk_prob10"):
        assert getattr(ours, attr) == getattr(theirs, attr), attr
    vocab = ours.vocab_list()
    assert vocab == theirs.vocab_list()
    for a, b in zip(ours.export_tables(), theirs.export_tables()):
        assert a.keys() == b.keys()
        for key in a:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    rng = np.random.RandomState(len(vocab))
    width = ours.order - 1
    for _ in range(200):
        n_ctx = rng.randint(0, width + 1)
        ctx = tuple(int(w) for w in rng.randint(0, len(vocab), size=n_ctx))
        wid = int(rng.randint(0, len(vocab)))
        assert ours.raw_score(ctx, wid) == theirs.raw_score(ctx, wid)
    n = 64
    ctx = rng.randint(-1, len(vocab), size=(n, width)).astype(np.int32)
    ctx_len = rng.randint(0, width + 1, size=n).astype(np.int32)
    ctx[np.arange(width)[None, :] < (width - ctx_len)[:, None]] = -1
    wids = rng.randint(0, len(vocab), size=n).astype(np.int32)
    for a, b in zip(ours.score_batch(ctx, ctx_len, wids), theirs.score_batch(ctx, ctx_len, wids)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["r1", "r3", "r4"])
def test_scores_equal_the_python_reader(files, name):
    """``tests/test_native.py``'s random-model parity: a walk of 300 words, states and scores."""
    nat, py = NativeNGramModel.from_file(files[name]), open_ngram_file(files[name], backend="python")
    rng = random.Random(len(name) + 100)
    rev_py = {v: k for k, v in py.tables.vocab.items()}
    vocab_nat = nat.native.vocab_list()
    state_py, state_nat = (), ()
    for _ in range(300):
        w = rng.choice(list(py.tables.vocab) + ["oovword"])
        sc_py, state_py = py.raw_score_word(state_py, w)
        sc_nat, state_nat = nat.raw_score_word(state_nat, w)
        assert sc_py == pytest.approx(sc_nat, abs=1e-6)
        assert tuple(rev_py[i] for i in state_py) == tuple(vocab_nat[i] for i in state_nat)
    assert (nat.begin_sentence_state() != ()) == (py.begin_sentence_state() != ())
    for w in ["w1", "<unk>", "absent"]:
        assert (w in nat) == (w in py)


@pytest.mark.parametrize("labels", ["chars", "libri"])
def test_device_tables_equal_the_jax_native_branch(files, labels):
    alphabet = SAMPLE_LABELS if labels == "chars" else [" "] + list("abcdefghijklmnopqrstuvwxyz") + ["'", ""]
    path = files["arpa"] if labels == "chars" else files["r3"]
    jdlm = jdt.build_device_lm(JLanguageModel(JNativeNGramModel.from_file(path), UNIGRAMS),
                               j_tokens(JAlphabet.build_alphabet(alphabet)))
    tdlm = tdt.build_device_lm(P.LanguageModel(NativeNGramModel.from_file(path), UNIGRAMS),
                               t_tokens(P.Alphabet.build_alphabet(alphabet)))
    for attr in ("order", "unk_id", "eos_id", "start_ctx_len", "has_unigrams"):
        assert getattr(tdlm, attr) == getattr(jdlm, attr), attr
    assert np.float32(tdlm.unk_prob10) == np.float32(jdlm.unk_prob10)
    for attr in ("start_ctx", "start_ctx_backoffs", "uni", "seed_node"):
        np.testing.assert_array_equal(getattr(tdlm, attr), getattr(jdlm, attr), err_msg=attr)
    np.testing.assert_array_equal(tdlm.trie.next, jdlm.trie.next)
    assert len(tdlm.fp_tables) == len(jdlm.fp_tables) == tdlm.order - 1
    for t, j in zip(tdlm.fp_tables, jdlm.fp_tables):
        assert (t.size, t.seed_lo, t.seed_hi, t.count, t.hash_mode) == (j.size, j.seed_lo, j.seed_hi, j.count, "fnv")
        np.testing.assert_array_equal(t.bucket, j.bucket)


def test_device_tables_hold_the_python_builds_entries(files):
    """The native build's tables hold the Python build's residents with their values.

    Sizes and seeds are equal; a bucket's residents may sit in other slots
    (each order's entries arrive in the engine's order, not the ARPA's), so
    the rows compare as sets of (fp_lo, fp_hi, prob, backoff) slots.
    """
    alphabet = t_tokens(P.Alphabet.build_alphabet(SAMPLE_LABELS))
    nat = tdt.build_device_lm(P.LanguageModel(open_ngram_file(files["r3"]), UNIGRAMS), alphabet)
    py = tdt.build_device_lm(P.LanguageModel(open_ngram_file(files["r3"], backend="python"), UNIGRAMS), alphabet)
    np.testing.assert_array_equal(nat.uni, py.uni)
    s = tdt._BUCKET_SLOTS
    for a, b in zip(nat.fp_tables, py.fp_tables):
        assert (a.size, a.seed_lo, a.seed_hi, a.count) == (b.size, b.seed_lo, b.seed_hi, b.count)
        for row_a, row_b in zip(a.bucket.view(np.uint32), b.bucket.view(np.uint32)):
            slots = []
            for row in (row_a, row_b):
                subs = row.reshape(-1, 4, s)  # [sub-block, field, slot]
                slots.append(sorted(tuple(subs[i, :, j]) for i in range(subs.shape[0]) for j in range(s)
                                    if subs[i, 0, j] != 0xFFFFFFFF))
            assert slots[0] == slots[1]


@pytest.fixture(scope="module")
def lm_pair(files):
    """(python, native) LanguageModels of the inline 3-gram."""
    return (P.LanguageModel(open_ngram_file(files["arpa"], backend="python"), UNIGRAMS),
            P.LanguageModel(open_ngram_file(files["arpa"], backend="native"), UNIGRAMS))


def test_device_decodes_equal_the_python_reader(lm_pair):
    alphabet = P.Alphabet.build_alphabet(SAMPLE_LABELS)
    py, nat = (P.TorchBeamSearchDecoderCTC(alphabet, lm, device="cpu") for lm in lm_pair)
    batch = [word_logits(s, t) for s, t in ((3, 30), (4, 17), (5, 24))]
    for kw in ({}, dict(token_chunking=2, blank_collapse=True)):
        for want, got in zip(py.decode_beams_batch(batch, beam_width=8, **kw),
                             nat.decode_beams_batch(batch, beam_width=8, **kw)):
            assert_same_beams(want, got, tol=0.0)


def test_host_decodes_equal_the_python_reader(lm_pair):
    alphabet = P.Alphabet.build_alphabet(SAMPLE_LABELS)
    hosts = [P.BeamSearchDecoderCTC(alphabet, lm) for lm in lm_pair]
    try:
        want, got = (h.decode_beams(TEST_LOGITS, beam_width=16) for h in hosts)
        assert [b.text for b in want] == [b.text for b in got]
        assert [b.lm_score for b in want] == [b.lm_score for b in got]
        assert hosts[1].decode(TEST_LOGITS) == "bugs bunny"
    finally:
        for h in hosts:
            h.cleanup()


@pytest.mark.parametrize("backend", ["auto", "native", "python"])
@pytest.mark.parametrize("name", ["arpa", "gz", "ctclm", "kenlm"])
def test_open_ngram_file_dispatch_equals_jax(files, name, backend):
    path = files[name]
    if backend == "native" and name in ("gz", "ctclm"):
        for opener in (open_ngram_file, j_open_ngram_file):
            with pytest.raises(ValueError, match="plain-text ARPA"):
                opener(path, backend=backend)
        return
    ours, theirs = open_ngram_file(path, backend=backend), j_open_ngram_file(path, backend=backend)
    assert type(ours).__name__ == type(theirs).__name__
    assert type(ours).__module__.startswith("pyctcdecode_torch.")
    assert ours.order == theirs.order == 3
    assert ours.raw_score_word((), "bunny") == theirs.raw_score_word((), "bunny")


def test_order_above_the_native_limit_is_refused(tmp_path):
    order = 17
    path = tmp_path / "wide.arpa"
    lines = ["\\data\\"] + [f"ngram {n}=1" for n in range(1, order + 1)] + [""]
    for n in range(1, order + 1):
        key = " ".join(f"w{i}" for i in range(n))
        lines += [f"\\{n}-grams:", f"-1.0\t{key}" + ("\t-0.1" if n < order else ""), ""]
    path.write_text("\n".join(lines + ["\\end\\", ""]))
    with pytest.raises(ValueError):
        NativeNGram(str(path))
    with pytest.raises(ValueError):
        open_ngram_file(str(path), backend="native")


def test_save_load_round_trip(files, tmp_path):
    """A directory of a natively read model reloads natively (``"auto"``), also as a decoder."""
    lm = P.LanguageModel(NativeNGramModel.from_file(files["arpa"]), UNIGRAMS, alpha=0.9)
    os.makedirs(tmp_path / "lm")
    lm.save_to_dir(str(tmp_path / "lm"))
    loaded = P.LanguageModel.load_from_dir(str(tmp_path / "lm"))
    assert isinstance(loaded.ngram_model, NativeNGramModel) and loaded.alpha == 0.9
    assert lm.score(lm.get_start_state(), "bugs") == loaded.score(loaded.get_start_state(), "bugs")
    dec = P.TorchBeamSearchDecoderCTC(P.Alphabet.build_alphabet(SAMPLE_LABELS), lm, device="cpu")
    os.makedirs(tmp_path / "dec")
    dec.save_to_dir(str(tmp_path / "dec"))
    again = P.TorchBeamSearchDecoderCTC.load_from_dir(str(tmp_path / "dec"), device="cpu")
    assert isinstance(again.language_model.ngram_model, NativeNGramModel)
    mat = word_logits(6, 26)
    assert_same_beams(dec.decode_beams(mat, beam_width=8), again.decode_beams(mat, beam_width=8), tol=0.0)


def test_an_unbuildable_engine_raises_under_native_and_falls_back_under_auto(files, monkeypatch):
    from pyctcdecode_torch.csrc import native

    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_LIB_ERROR", "RuntimeError: no g++")
    with pytest.raises(RuntimeError, match="no g\\+\\+"):
        open_ngram_file(files["arpa"], backend="native")
    assert type(open_ngram_file(files["arpa"])) is P.NGramModel
