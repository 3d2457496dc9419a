"""Decoder serialization in the port, held against the JAX package's.

``save_to_dir`` / ``parse_directory_contents`` / ``load_from_dir`` /
``load_from_hf_hub`` of both port engines (``TorchBeamSearchDecoderCTC`` on
the CPU and the host oracle ``BeamSearchDecoderCTC``):

* they write the files the JAX package writes (names, ``attrs.json``,
  ``unigrams.txt`` bytes, the model file copied);
* a directory saved by the JAX package loads in the port and decodes as the
  JAX package's ``load_from_dir`` decoder does, and the reverse (device
  engines: texts, ``text_frames`` and LM states identical, scores within
  1e-4; host engines: equal);
* ``parse_directory_contents`` refuses the layouts the JAX package refuses,
  with the same exception type;
* round trips with no LM, ARPA, ``.arpa.gz``, KenLM PROBING and QUANT_TRIE
  binaries and ``.ctclm``;
* the hub over a faked local cache with ``local_files_only=True``: nothing
  is downloaded.
"""
import gzip
import json
import os
import sys

import numpy as np
import pytest
import torch

import pyctcdecode_torch as P
from pyctcdecode_torch.models.ngram import NGramModel, NGramTables, open_ngram_file
from pyctcdecode_tpu import Alphabet as JAlphabet
from pyctcdecode_tpu import BeamSearchDecoderCTC as JBeamSearchDecoderCTC
from pyctcdecode_tpu import LanguageModel as JLanguageModel
from pyctcdecode_tpu import TPUBeamSearchDecoderCTC
from pyctcdecode_tpu.models.binfmt import write_binary
from pyctcdecode_tpu.models.kenlm_bin import write_kenlm_binary
from pyctcdecode_tpu.models.kenlm_trie import write_kenlm_trie
from pyctcdecode_tpu.models.native import open_ngram_file as j_open_ngram_file
from pyctcdecode_tpu.models.ngram import read_arpa

from .helpers import SAMPLE_LABELS, TEST_LOGITS
from .torch_cases import ARPA, UNIGRAMS, assert_same_beams, word_logits
from .torch_cases import jax_native, one_torch_thread  # noqa: F401  (autouse fixtures)

ATTRS = dict(alpha=0.7, beta=2.5, unk_score_offset=-8.0, score_boundary=False)
BATCH = [word_logits(30, 28), word_logits(31, 35)]


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """The inline 3-gram as every model file a decoder directory may hold (the JAX package's writers)."""
    root = tmp_path_factory.mktemp("models")
    paths = {"arpa": str(root / "bb3.arpa"), "arpa.gz": str(root / "bb3.arpa.gz")}
    with open(paths["arpa"], "w") as fh:
        fh.write(ARPA)
    with gzip.open(paths["arpa.gz"], "wt") as fh:
        fh.write(ARPA)
    tables = read_arpa(paths["arpa"])
    paths["probing"] = str(root / "bb3.bin")
    write_kenlm_binary(tables, paths["probing"])
    paths["quant_trie"] = str(root / "bb3_q.binary")
    write_kenlm_trie(tables, paths["quant_trie"], quant_bits=(4, 4))
    paths["ctclm"] = str(root / "bb3.ctclm")
    write_binary(tables, paths["ctclm"])
    return paths


def _port(engine, path, **attrs):
    lm = None if path is None else P.LanguageModel(open_ngram_file(path), UNIGRAMS, **attrs)
    alphabet = P.Alphabet.build_alphabet(SAMPLE_LABELS)
    if engine == "host":
        return P.BeamSearchDecoderCTC(alphabet, lm)
    return P.TorchBeamSearchDecoderCTC(alphabet, lm, device="cpu")


def _jax(engine, path, **attrs):
    lm = None if path is None else JLanguageModel(j_open_ngram_file(path), UNIGRAMS, **attrs)
    cls = JBeamSearchDecoderCTC if engine == "host" else TPUBeamSearchDecoderCTC
    return cls(JAlphabet.build_alphabet(SAMPLE_LABELS), lm)


def _lm(dec):
    """A port decoder's language model, either engine."""
    return dec.language_model if isinstance(dec, P.TorchBeamSearchDecoderCTC) else dec._language_model


def _listing(root):
    return sorted(os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root) for f in fs)


def _read(path, mode="rb"):
    with open(path, mode) as fh:
        return fh.read()


def _assert_same_decodes(want_dec, got_dec, engine):
    want = want_dec.decode_beams_batch(BATCH, beam_width=12) if engine == "torch" else \
        [want_dec.decode_beams(m, beam_width=12) for m in BATCH]
    got = got_dec.decode_beams_batch(BATCH, beam_width=12) if engine == "torch" else \
        [got_dec.decode_beams(m, beam_width=12) for m in BATCH]
    for w, g in zip(want, got):
        assert_same_beams(w, g, tol=1e-4 if engine == "torch" else 0.0)


@pytest.mark.parametrize("engine", ["torch", "host"])
@pytest.mark.parametrize("model", ["arpa", "probing"])
def test_save_to_dir_writes_the_files_jax_writes(models, tmp_path, engine, model):
    ours, theirs = tmp_path / "ours", tmp_path / "theirs"
    ours.mkdir()
    theirs.mkdir()
    _port(engine, models[model], **ATTRS).save_to_dir(str(ours))
    _jax(engine, models[model], **ATTRS).save_to_dir(str(theirs))
    name = os.path.basename(models[model])
    assert _listing(ours) == _listing(theirs) == sorted(
        ["alphabet.json", f"language_model{os.sep}attrs.json", f"language_model{os.sep}unigrams.txt",
         f"language_model{os.sep}{name}"])
    for rel in _listing(ours):
        assert _read(ours / rel) == _read(theirs / rel), rel
    assert json.loads(_read(ours / "language_model" / "attrs.json", "r")) == ATTRS
    assert _read(ours / "language_model" / "unigrams.txt", "r").splitlines() == sorted(UNIGRAMS)


@pytest.mark.parametrize("model", ["arpa", "probing", "ctclm"])
def test_directories_cross_between_the_packages(models, tmp_path, model):
    """Saved by JAX, loaded by the port (and the reverse): each loads and decodes as the other's load does."""
    for engine in ("torch", "host"):
        j_dir, p_dir = tmp_path / f"{engine}_jax", tmp_path / f"{engine}_port"
        j_dir.mkdir()
        p_dir.mkdir()
        _jax(engine, models[model], **ATTRS).save_to_dir(str(j_dir))
        _port(engine, models[model], **ATTRS).save_to_dir(str(p_dir))
        j_cls = TPUBeamSearchDecoderCTC if engine == "torch" else JBeamSearchDecoderCTC
        kw = dict(device="cpu") if engine == "torch" else {}
        p_cls = P.TorchBeamSearchDecoderCTC if engine == "torch" else P.BeamSearchDecoderCTC
        for src in (j_dir, p_dir):
            jdec, pdec = j_cls.load_from_dir(str(src)), p_cls.load_from_dir(str(src), **kw)
            assert _lm(pdec).serializable_attrs == ATTRS
            _assert_same_decodes(jdec, pdec, engine)


DECODER_LAYOUTS = [
    (), ("alphabet.json",), ("alphabet.json", "language_model/"), ("language_model/",),
    ("alphabet.wrong-ext", "language_model/"), ("alphabet.json", "extra.txt"),
    ("alphabet.json", "language_model/", ".hidden", "__pycache__/"),
]
LM_LAYOUTS = [
    ("attrs.json", "unigrams.txt", "m.arpa"), ("attrs.json", "unigrams.txt", "m.arpa.gz"),
    ("attrs.json", "unigrams.txt", "m.bin"), ("attrs.json", "unigrams.txt", "m.ctclm"),
    ("attrs.json", "unigrams.txt", "m.binary", ".hidden"), ("attrs.json", "unigrams.txt"),
    ("attrs.json", "unigrams.txt", "m.txt"), ("attrs.json", "unigrams.txt", "m.gz"),
    ("attrs.json", "words.txt", "m.arpa"), ("params.json", "unigrams.txt", "m.arpa"),
    ("attrs.json", "unigrams.txt", "m.arpa", "n.arpa"),
]


def _outcome(fn):
    try:
        return fn()
    except Exception as err:  # the exception type is the outcome compared
        return type(err)


@pytest.mark.parametrize("layout", DECODER_LAYOUTS + LM_LAYOUTS, ids=lambda t: "+".join(t) or "empty")
def test_parse_directory_contents_refuses_what_jax_refuses(tmp_path, layout):
    for name in layout:
        if name.endswith("/"):
            (tmp_path / name).mkdir()
        else:
            (tmp_path / name).write_text("x")
    root = str(tmp_path)
    if layout in LM_LAYOUTS:
        pairs = [(JLanguageModel.parse_directory_contents, P.LanguageModel.parse_directory_contents)]
    else:
        pairs = [(JBeamSearchDecoderCTC.parse_directory_contents, P.BeamSearchDecoderCTC.parse_directory_contents),
                 (TPUBeamSearchDecoderCTC.parse_directory_contents,
                  P.TorchBeamSearchDecoderCTC.parse_directory_contents)]
    for j_fn, p_fn in pairs:
        want, got = _outcome(lambda: j_fn(root)), _outcome(lambda: p_fn(root))
        assert got == want


@pytest.mark.parametrize("model", [None, "arpa", "arpa.gz", "probing", "quant_trie", "ctclm"])
def test_round_trips(models, tmp_path, model):
    path = None if model is None else models[model]
    for engine in ("torch", "host"):
        out = tmp_path / engine
        out.mkdir()
        dec = _port(engine, path, **ATTRS)
        dec.save_to_dir(str(out))
        kw = dict(device="cpu") if engine == "torch" else {}
        cls = P.TorchBeamSearchDecoderCTC if engine == "torch" else P.BeamSearchDecoderCTC
        loaded = cls.load_from_dir(str(out), **kw)
        if model is None:
            assert not os.path.exists(out / "language_model")
        else:
            assert os.path.basename(path) in os.listdir(out / "language_model")
            lm = _lm(loaded)
            assert type(lm.ngram_model) is type(open_ngram_file(path))
            assert lm.serializable_attrs == ATTRS and lm.unigram_set == set(UNIGRAMS)
        _assert_same_decodes(dec, loaded, engine)
        assert loaded.decode(TEST_LOGITS) == ("bunny bunny" if model is None else "bugs bunny")


def test_load_from_dir_runs_on_cuda_unless_asked(models, tmp_path):
    _port("torch", models["probing"]).save_to_dir(str(tmp_path))
    dec = P.TorchBeamSearchDecoderCTC.load_from_dir(str(tmp_path), device="cpu")
    assert dec.device == torch.device("cpu")
    assert all(t["bucket"].device.type == "cpu" for t in dec._tabs["lms"][0]["fp"])
    if torch.cuda.is_available():
        assert P.TorchBeamSearchDecoderCTC.load_from_dir(str(tmp_path)).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            P.TorchBeamSearchDecoderCTC.load_from_dir(str(tmp_path))


def test_save_to_dir_checks_for_a_model_file_before_writing(tmp_path):
    """An LM with no backing file refuses before it writes attrs.json or unigrams.txt, as JAX's does."""
    one = (np.float32(-1.0), np.float32(0.0))
    tables = NGramTables(order=2, vocab={"<unk>": 0, "bugs": 1}, ngrams=[{(0,): one, (1,): one}, {}], path=None)
    for engine in ("torch", "host"):
        out = tmp_path / engine
        out.mkdir()
        lm = P.LanguageModel(NGramModel(tables), ["bugs"])
        alphabet = P.Alphabet.build_alphabet(SAMPLE_LABELS)
        dec = P.TorchBeamSearchDecoderCTC(alphabet, lm, device="cpu") if engine == "torch" else \
            P.BeamSearchDecoderCTC(alphabet, lm)
        with pytest.raises(ValueError, match="no backing file"):
            dec.save_to_dir(str(out))
        assert _listing(out) == ["alphabet.json"]


def test_load_from_hf_hub_reads_a_local_cache(models, tmp_path, monkeypatch):
    """A faked hub cache (the modern layout), ``local_files_only=True``: both engines load it; nothing is fetched."""
    try:
        from huggingface_hub.constants import REPO_ID_SEPARATOR
    except ImportError:
        pytest.skip("huggingface_hub is not installed")
    name = "someone/dummy_test".replace("/", REPO_ID_SEPARATOR)
    sha = "123456abcdef"
    models_dir = tmp_path / f"models{REPO_ID_SEPARATOR}{name}"
    snap = models_dir / "snapshots" / sha
    snap.mkdir(parents=True)
    (models_dir / "refs").mkdir()
    (models_dir / "refs" / "main").write_text(sha)
    saved = _port("torch", models["probing"], **ATTRS)
    saved.save_to_dir(str(snap))
    dec = P.TorchBeamSearchDecoderCTC.load_from_hf_hub(
        "someone/dummy_test", cache_dir=str(tmp_path), local_files_only=True, device="cpu")
    _assert_same_decodes(saved, dec, "torch")
    host = P.BeamSearchDecoderCTC.load_from_hf_hub("someone/dummy_test", cache_dir=str(tmp_path),
                                                   local_files_only=True)
    assert host.decode(TEST_LOGITS) == dec.decode(TEST_LOGITS) == "bugs bunny"
    host.cleanup()
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)  # the optional package absent
    for cls in (P.TorchBeamSearchDecoderCTC, P.BeamSearchDecoderCTC):
        with pytest.raises(ImportError, match="huggingface_hub"):
            cls.load_from_hf_hub("someone/dummy_test", cache_dir=str(tmp_path), local_files_only=True)
