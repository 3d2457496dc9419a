"""The host tracer's spans around an ensemble's member loads, and its hotword-table counters.

A caller that builds a ``MultiLanguageModel`` loads each member itself:
``open_ngram_file``, ``load_unigram_set_from_arpa`` and ``LanguageModel``.
With the tracer on, each is a root span of its own (``lm.read``,
``lm.unigrams``, ``lm.language_model``); inside ``build_ctcdecoder``'s
``build`` root the same sites open nothing, so the build records the
stages it always recorded. ``_hot_tables`` counts ``hot.tables_built``
where a call builds and uploads a hotword trie and ``hot.tables_cached``
where the cache answers. The benchmark's reader ``member_load_s`` sums the
member roots of a run's set-up, and reads nothing without them.
"""
import pytest

import pyctcdecode_torch as P
from cardbench.harness import manifest, program
from pyctcdecode_torch.models.ngram import load_unigram_set_from_arpa, open_ngram_file
from pyctcdecode_torch.utils import profiling

from .helpers import SAMPLE_LABELS
from .test_torch_tracing import BUILD_STAGES, _assert_tiled, _roots
from .torch_cases import ARPA, ARPA_2GRAM, word_logits
from .torch_cases import one_torch_thread  # noqa: F401  (autouse fixture)

BEAM = 8
MEMBER_ROOTS = ["lm.read", "lm.unigrams", "lm.language_model"]
HOT = ["bunny", "sun gun", "qzx"]


@pytest.fixture(scope="module")
def arpas(tmp_path_factory):
    root = tmp_path_factory.mktemp("lms")
    paths = [root / "a.arpa", root / "b.arpa"]
    paths[0].write_text(ARPA)
    paths[1].write_text(ARPA_2GRAM)
    return [str(p) for p in paths]


def _ensemble(paths):
    """Two members built as users build them, one site call each."""
    members = [P.LanguageModel(open_ngram_file(path), load_unigram_set_from_arpa(path), alpha=alpha)
               for path, alpha in zip(paths, (0.5, 0.3))]
    return P.MultiLanguageModel(members)


def test_an_ensemble_records_one_root_a_site_a_member(arpas):
    with profiling.tracing() as tr:
        ensemble = _ensemble(arpas)
        P.TorchBeamSearchDecoderCTC(P.Alphabet.build_alphabet(SAMPLE_LABELS), ensemble, device="cpu")
    spans, _ = tr.drain()
    roots = [s for s in spans if s.parent < 0]
    assert [s.name for s in roots] == MEMBER_ROOTS * 2 + ["build"]
    assert len({s.call for s in roots}) == len(roots)
    assert all(s.end_ns is not None and s.start_ns <= s.end_ns for s in spans)
    assert not [s for s in spans if s.parent >= 0 and s.name in MEMBER_ROOTS]
    # the decoder's own build root holds its device tables alone
    _assert_tiled(spans, roots[-1], BUILD_STAGES[3:])


def test_build_ctcdecoder_records_the_stages_it_always_recorded(arpas):
    with profiling.tracing() as tr:
        P.build_ctcdecoder(SAMPLE_LABELS, arpas[0], device="cpu")
    spans, _ = tr.drain()
    (root,) = _roots(spans, "build")
    assert [s.name for s in spans if s.parent < 0] == ["build"]
    assert len(spans) == 1 + len(BUILD_STAGES)
    _assert_tiled(spans, root, BUILD_STAGES)


def test_the_sites_record_nothing_with_the_tracer_off(arpas):
    with profiling.tracing() as tr:
        pass
    assert profiling.TRACER is None
    dec = P.TorchBeamSearchDecoderCTC(P.Alphabet.build_alphabet(SAMPLE_LABELS), _ensemble(arpas), device="cpu")
    dec.decode_beams_batch([word_logits(51, 30)], beam_width=BEAM, hotwords=HOT)
    assert profiling.call("lm.read") is profiling.call("lm.unigrams")  # the one shared no-op context
    spans, counters = tr.drain()
    assert spans == [] and not {k: n for k, n in counters.items() if n}


def test_the_hotword_tables_are_built_once_and_then_cached(arpas):
    dec = P.TorchBeamSearchDecoderCTC(P.Alphabet.build_alphabet(SAMPLE_LABELS), _ensemble(arpas), device="cpu")
    batch = [word_logits(52, 30), word_logits(53, 24)]
    with profiling.tracing() as tr:
        dec.decode_beams_batch(batch, beam_width=BEAM, hotwords=HOT, hotword_weight=10.0)
        _, first = tr.drain()
        dec.decode_beams_batch(batch, beam_width=BEAM, hotwords=list(reversed(HOT)), hotword_weight=10.0)
        _, second = tr.drain()
        dec.decode_beams_batch(batch, beam_width=BEAM)
        _, bare = tr.drain()
    assert first["hot.tables_built"] == 1 and "hot.tables_cached" not in first
    assert second["hot.tables_cached"] == 1 and "hot.tables_built" not in second
    assert "hot.tables_built" not in bare and "hot.tables_cached" not in bare


def _setup_record(fn):
    """A run's record whose set-up phase holds the spans ``fn`` recorded (``cardbench.harness.program``)."""
    with profiling.tracing() as tr:
        fn()
        return dict(kind="batch", program=dict(setup=program.drain(tr)))


def test_member_load_s_reads_the_member_roots_of_the_setup(arpas):
    read = manifest.reader("member_load_s")
    ensemble = _setup_record(lambda: _ensemble(arpas))
    roots = [s for s in ensemble["program"]["setup"]["spans"] if s["parent"] < 0]
    assert [s["name"] for s in roots] == MEMBER_ROOTS * 2
    assert read(ensemble) == pytest.approx(sum(s["end"] - s["start"] for s in roots)) and read(ensemble) > 0
    single = _setup_record(lambda: P.build_ctcdecoder(SAMPLE_LABELS, arpas[0], device="cpu"))
    assert read(single) is None
    assert manifest.reader("lm_read_s")(single) > 0 and manifest.reader("lm_read_s")(ensemble) is None
    assert read(dict(kind="batch")) is None  # a run with the tracer off
    assert read(dict(kind="batch", program=dict(setup=dict(spans=[], counters={})))) is None
