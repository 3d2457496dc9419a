"""wav2vec2-base-960h's 32 labels on the torch engine: the LM's ``<s>`` / ``</s>`` as decoded words.

The tokenizer's labels carry ``<s>`` and ``</s>`` as letters, so a beam can
decode the LM's sentence markers as words. The host engines (the JAX
package's ``BeamSearchDecoderCTC`` and the port's ``engine="host"``, both
float64) and the benchmark's plain reference (``cardbench/reference/``,
Python and NumPy in float64, importing nothing of the program) score such a
word as the LM's own word; the torch engine has to do the same. Every case
first holds the port's host engine to the JAX package's, to the last bit,
then the torch engine (``device="cpu"``) to them and to the reference, on an
inline 3-gram whose n-grams run through the markers: one-hot paths that
decode ``</s>`` mid-utterance and at the end, ``<s>`` first, the unknown
token ``⁇``; seeded random logits through ``decode_beams_batch`` (three
utterances of uneven length, eager and in segments) and through chunked
``partial_decode_beams``. Texts, ``text_frames`` and ``last_lm_state`` (or a
view's partial word and spans) must be equal, scores within ``SCORE_TOL``. A
char alphabet that spells the markers letter by letter also leaves the
partial word ``</`` open at ``is_end``.

The same decodes on the card are in ``test_torch_w2v2_cuda``, which imports
no JAX.
"""
import pytest

import pyctcdecode_torch as P
import pyctcdecode_tpu as J
from cardbench.reference.arpa import ArpaModel
from cardbench.reference.decoder import ReferenceDecoder
from pyctcdecode_torch.models.ngram import load_unigram_set_from_arpa
from pyctcdecode_torch.utils import profiling
from pyctcdecode_tpu.decoder import Beam as JBeam

from .torch_cases import SCORE_TOL, assert_same_beams, assert_same_views
from .torch_cases import one_torch_thread  # noqa: F401  (autouse fixture)
from .w2v2_cases import (
    ARPA,
    BEAM,
    PATHS,
    QUARTZNET_LABELS,
    SPELLED_LABELS,
    W2V2_LABELS,
    WORDS_ONLY,
    assert_same_as_reference,
    assert_same_reference_views,
    chunks_of,
    device_stream,
    host_stream,
    path_logits,
    random_logits,
)


@pytest.fixture(scope="module")
def arpa_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("lm") / "markers.arpa"
    path.write_text(ARPA)
    return str(path)


class Engines:
    """The JAX package's host engine, the port's host engine, its torch engine on the CPU, the reference."""

    def __init__(self, labels, arpa_path, words):
        self.jhost = J.build_ctcdecoder(labels, arpa_path, words, engine="host")
        self.host = P.build_ctcdecoder(labels, arpa_path, words, engine="host")
        self.dev = P.build_ctcdecoder(labels, arpa_path, words, device="cpu")
        model = ArpaModel(arpa_path)
        if words is not None:
            model.unigram_lines = list(words)
        self.ref = ReferenceDecoder(labels, model)
        self._host = {}

    def host_beams(self, mat):
        """The port's host beams, held to the JAX package's to the bit on first use (the segmented cases reuse them)."""
        key = mat.tobytes()
        if key not in self._host:
            want = self.jhost.decode_beams(mat, beam_width=BEAM)
            got = self.host.decode_beams(mat, beam_width=BEAM)
            assert_same_beams(want, got, tol=0.0)
            self._host[key] = got
        return self._host[key]

    def host_views(self, chunks):
        want = host_stream(self.jhost, chunks, JBeam)
        got = host_stream(self.host, chunks)
        for w, g in zip(want, got):
            assert_same_views(w, g, tol=0.0)
        return got


@pytest.fixture(scope="module")
def decoders(arpa_path):
    """:class:`Engines` by (labels, unigram source), built on first use."""
    made = {}

    def get(labels=W2V2_LABELS, unigrams="arpa"):
        key = (tuple(labels), unigrams)
        if key not in made:
            made[key] = Engines(labels, arpa_path, None if unigrams == "arpa" else WORDS_ONLY)
        return made[key]

    yield get
    J.BeamSearchDecoderCTC.clear_class_models()
    P.BeamSearchDecoderCTC.clear_class_models()


# -- the one-hot paths --------------------------------------------------------------------------------
@pytest.mark.parametrize("peak", [6.0, 12.0])
@pytest.mark.parametrize("unigrams", ["arpa", "words"])
@pytest.mark.parametrize("case", sorted(PATHS))
def test_marker_paths_decode_as_the_host_engine_and_the_reference(decoders, case, unigrams, peak):
    eng = decoders(unigrams=unigrams)
    mat = path_logits(W2V2_LABELS, PATHS[case], seed=len(case), peak=peak)
    want = eng.host_beams(mat)
    got = eng.dev.decode_beams(mat, beam_width=BEAM)
    if peak > 6.0:
        assert got[0].text == " ".join(PATHS[case].split())
    assert_same_beams(want, got)
    assert_same_as_reference(eng.ref.decode(mat, beam_width=BEAM), got, eng.ref.lm.words)


@pytest.mark.parametrize("case", ["eos_mid", "eos_end", "bos_first", "markers_run_on"])
def test_a_decoded_marker_is_scored_as_the_lms_word(decoders, case):
    """The fused LM score of the top beam is the LM's, word by word: no unknown-word offset for a marker."""
    eng = decoders()
    mat = path_logits(W2V2_LABELS, PATHS[case], seed=3)
    top = eng.dev.decode_beams(mat, beam_width=BEAM)[0]
    for lm in (eng.jhost._language_model, eng.host._language_model):
        state, want = lm.get_start_state(), 0.0
        words = top.text.split()
        for i, word in enumerate(words):
            score, state = lm.score(state, word, is_last_word=i == len(words) - 1)
            want += score
        assert top.last_lm_state.context == state.context
        assert abs((top.lm_score - top.logit_score) - want) <= SCORE_TOL


@pytest.mark.parametrize("text,partial", [("bugs </", "</"), ("bugs <", "<"), ("</s", "</s"), ("bugs </s>", "</s>")])
def test_spelled_markers_leave_partial_words_open_at_the_end(decoders, text, partial):
    """An alphabet with ``<``, ``/`` and ``>`` as letters: the partial words of the markers, open at ``is_end``."""
    eng = decoders(SPELLED_LABELS)
    mat = path_logits(SPELLED_LABELS, text, seed=5)
    chunks = [mat, mat[:0]]  # the partial word stays open through the first chunk; the empty last one ends it
    want, got = eng.host_views(chunks), device_stream(eng.dev, chunks)
    assert got[0][0].partial_word == partial
    assert got[-1][0].text == " ".join(text.split())
    for w, g in zip(want, got):
        assert_same_views(w, g)
    for w, g in zip(eng.ref.stream(chunks, beam_width=BEAM), got):
        assert_same_reference_views(w, g)
    assert_same_beams(eng.host_beams(mat), eng.dev.decode_beams(mat, beam_width=BEAM))


# -- seeded random logits --------------------------------------------------------------------------
@pytest.mark.parametrize("seg", [0, 4])
@pytest.mark.parametrize("seed", range(6))
def test_random_batches_equal_the_host_engine_and_the_reference(decoders, seed, seg):
    eng = decoders(unigrams="words" if seed % 2 else "arpa")
    dev = eng.dev.with_options(segment_frames=seg)
    mats = [random_logits(10 * seed + i, t) for i, t in enumerate((60, 23, 41))]
    got = dev.decode_beams_batch(mats, beam_width=BEAM)
    for mat, beams in zip(mats, got):
        assert_same_beams(eng.host_beams(mat), beams)
        if seg == 0:
            assert_same_as_reference(eng.ref.decode(mat, beam_width=BEAM), beams, eng.ref.lm.words)


@pytest.mark.parametrize("seed", range(6))
def test_random_streams_equal_the_host_engine_and_the_reference(decoders, seed):
    eng = decoders(unigrams="words" if seed % 2 else "arpa")
    chunks = chunks_of(random_logits(100 + seed, 50), 7 + seed)
    got = device_stream(eng.dev, chunks)
    for w, g in zip(eng.host_views(chunks), got):
        assert_same_views(w, g)
    for w, g in zip(eng.ref.stream(chunks, beam_width=BEAM), got):
        assert_same_reference_views(w, g)


def test_the_random_logits_decode_the_markers(decoders):
    """The random cases above reach the markers: some returned beam holds one as a word."""
    dev = decoders().dev
    mats = [random_logits(10 * seed + i, t) for seed in range(6) for i, t in enumerate((60, 23, 41))]
    words = {w for beams in dev.decode_beams_batch(mats, beam_width=BEAM) for b in beams for w in b.text.split()}
    assert {"<s>", "</s>"} <= words


def test_the_unigram_sets_agree_with_the_reference(arpa_path):
    """The host engine's unigram set (markers included, from the ARPA file) is the reference's."""
    want = set(ArpaModel(arpa_path).unigram_lines)
    assert load_unigram_set_from_arpa(arpa_path) == want and {"<s>", "</s>"} <= want


# -- the counters --------------------------------------------------------------------------------------
def test_build_counts_the_sentence_words_the_device_trie_holds(arpa_path):
    counts = {}
    for name, labels in (("w2v2", W2V2_LABELS), ("spelled", SPELLED_LABELS), ("quartznet", QUARTZNET_LABELS)):
        with profiling.tracing() as tr:
            P.build_ctcdecoder(labels, arpa_path, device="cpu")
        counts[name] = tr.counters()["build.sentence_words"]
    assert counts == {"w2v2": 2, "spelled": 2, "quartznet": 0}


def test_replay_counts_the_beams_that_hold_a_marker(decoders):
    dev = decoders().dev
    mats = [path_logits(W2V2_LABELS, PATHS["eos_mid"]), path_logits(W2V2_LABELS, "bunny sun")]
    with profiling.tracing() as tr:
        out = dev.decode_beams_batch(mats, beam_width=BEAM)
        _, batch = tr.drain()
        views = device_stream(dev, chunks_of(mats[0], 5))
        _, stream = tr.drain()
    returned = [b for beams in out for b in beams]
    assert batch["replay.beams"] == len(returned)
    assert batch["replay.sentence_beams"] == sum("</s>" in b.text.split() or "<s>" in b.text.split()
                                                 for b in returned) > 0
    assert stream["replay.beams"] == sum(len(v) for v in views)
    assert 0 < stream["replay.sentence_beams"] <= stream["replay.beams"]
    assert not profiling.TRACER
