"""The plain reference against the program at tiny sizes on the CPU, and the control that must fail.

The reference decodes the same raw logits over its own read of the same
ARPA text; its beams must carry what the program's carry (texts, word
frames, LM states; scores within float32 rounding). The control, the
reference computed in bfloat16, put in the program's place, must fail the
limits of the cells (``cardbench/limits``). An ensemble of two LMs with
hotwords is held against both of the program's engines (the host engine
``BeamSearchDecoderCTC`` and the device engine on the CPU), batch and
stream.
"""
import numpy as np
import pytest

from cardbench.harness import data, judge, manifest, traffic
from cardbench.reference.arpa import ArpaModel
from cardbench.reference.decoder import Member, ReferenceDecoder, to_bf16
from cardbench.tests.tiny import MEMBERS

import pyctcdecode_torch as P
from pyctcdecode_torch.decoder import Beam
from pyctcdecode_torch.models.hotwords import HotwordScorer
from pyctcdecode_torch.models.ngram import load_unigram_set_from_arpa, open_ngram_file

BEAM = 16
SCORE_TOL = 1e-4
HOT_WEIGHT = 6.0


@pytest.fixture(scope="module")
def lm(tmp_path_factory):
    path = tmp_path_factory.mktemp("lm") / "lm.arpa"
    vocab = data.write_parity_arpa(str(path), 2000, 3000, 2000, 7)
    return path, vocab


def _inputs(vocab, labels, is_bpe, n=3, seed=5):
    mix = dict(generator="batch", rows=n, frames=[60, 110], pool=1)
    ctx = traffic.context(vocab[:300] + data.TRANSCRIPT.split(), labels, is_bpe, 0.02)
    return traffic.make(mix, seed, ctx)["pool"][0]


def _raw_labels(alphabet, vocab):
    """The raw labels: the QuartzNet configuration's 28 characters, or BPE pieces grown from ``vocab``."""
    if alphabet == "char":
        return manifest.config(manifest.manifest(), "quartznet-char-3gram")["labels"]
    return data.bpe_vocabulary(vocab)


@pytest.mark.parametrize("alphabet", ["char", "bpe"])
def test_reference_equals_the_program_batch(lm, alphabet):
    path, vocab = lm
    raw = _raw_labels(alphabet, vocab)
    model = ArpaModel(str(path))
    ref = ReferenceDecoder(raw, model)
    mats = _inputs(vocab, ref.labels, ref.is_bpe)
    dec = P.build_ctcdecoder(raw, str(path), device="cpu")
    got = dec.decode_beams_batch(mats, beam_width=BEAM)
    pairs = []
    for m, beams in zip(mats, got):
        want = ref.decode(m, beam_width=BEAM)
        mine = judge.program_output(beams, model.words)
        assert [b["text"] for b in mine[:3]] == [b["text"] for b in want[:3]]
        assert mine[0]["frames"] == want[0]["frames"] and mine[0]["state"] == want[0]["state"]
        pairs.append((mine, want))
    numbers = judge.compare(pairs)
    assert numbers["missing"] == 0 and numbers["top_gap"] == 0 and numbers["score_err"] < SCORE_TOL


def test_reference_equals_the_program_stream(lm):
    path, vocab = lm
    raw = _raw_labels("char", vocab)
    model = ArpaModel(str(path))
    ref = ReferenceDecoder(raw, model)
    mat = _inputs(vocab, ref.labels, False, n=1)[0]
    chunks = traffic.chunks(mat, 25)
    dec = P.build_ctcdecoder(raw, str(path), device="cpu")
    state = dec.get_starting_state(beam_width=BEAM)
    views = [dec.partial_decode_beams(state, c, is_end=i == len(chunks) - 1) for i, c in enumerate(chunks)]
    want = ref.stream(chunks, beam_width=BEAM)
    pairs = [(judge.program_view(v), judge.reference_view(w)) for v, w in zip(views, want)]
    numbers = judge.compare(pairs)
    assert numbers["missing"] == 0 and numbers["top_gap"] == 0 and numbers["score_err"] < SCORE_TOL


def test_bf16_rounding():
    assert to_bf16(1.0) == 1.0
    assert to_bf16(1.0 + 2**-9) == 1.0  # a tie goes to even
    assert to_bf16(1.0 + 3 * 2**-9) == 1.0 + 2**-7
    assert to_bf16(-100.3) == -100.5


@pytest.mark.parametrize("cell", ["quartznet-char-3gram.dense32", "conformer-bpe128-3gram.dense32"])
def test_the_control_fails_the_cells_limits(lm, cell):
    path, vocab = lm
    bench = manifest.manifest()
    raw = manifest.config(bench, manifest.cell(bench, cell)["config"])["labels"]
    if raw[0] == "<unk>":
        raw = data.bpe_vocabulary(vocab)
    model = ArpaModel(str(path))
    ref, low = ReferenceDecoder(raw, model), ReferenceDecoder(raw, model, precision="bf16")
    mats = _inputs(vocab, ref.labels, ref.is_bpe, n=4, seed=9)
    pairs = [(low.decode(m, beam_width=BEAM), ref.decode(m, beam_width=BEAM)) for m in mats]
    assert not judge.verdict(judge.compare(pairs), manifest.limits(cell))


def test_a_decoded_end_of_sentence_word_is_the_lms_word_as_in_the_host_engine(lm):
    """wav2vec2's labels carry ``</s>``: a decoded word ``</s>`` is the LM's word, as the host engine scores it.

    The second witness of the device decoder's fault that keeps the
    wav2vec2 configuration out of the benchmark (``PERF.md``): the program's
    host engine and the reference agree on it.
    """
    import numpy as np

    path, _ = lm
    raw = manifest.load_json(manifest.BENCH_DIR / "configs" / "w2v2-char-3gram.json")["labels"]
    model = ArpaModel(str(path))
    ref = ReferenceDecoder(raw, model)
    col = {c: i for i, c in enumerate(ref.labels)}
    seq = [col[c] for c in "have"] + [col[" "], col["</s>"], col[""], col[""]]
    mat = np.full((len(seq), len(ref.labels)), -8.0, np.float32)
    mat[np.arange(len(seq)), seq] = 8.0
    want = ref.decode(mat, beam_width=BEAM)
    host = P.build_ctcdecoder(raw, str(path), engine="host").decode_beams(mat, beam_width=BEAM)
    assert want[0]["text"] == host[0].text == "have </s>"
    assert abs(want[0]["lm"] - float(host[0].lm_score)) < SCORE_TOL
    assert "</s>" in model and want[0]["state"][-1] == "</s>"


# -- an ensemble of two LMs, with hotwords ---------------------------------------------------------

@pytest.fixture(scope="module")
def ensemble(tmp_path_factory):
    """Two parity 3-grams of one seed: member A, and member B at half its bigrams and trigrams."""
    root = tmp_path_factory.mktemp("ensemble")
    paths = [root / "a.arpa", root / "b.arpa"]
    vocab = data.write_parity_arpa(str(paths[0]), 2000, 3000, 2000, 7)
    assert data.write_parity_arpa(str(paths[1]), 2000, 1500, 1000, 7) == vocab
    return [str(path) for path in paths], vocab


def _members(paths, precision="f64", hotwords=()):
    """The reference over the two members at :data:`MEMBERS`' settings."""
    members = [Member(ArpaModel(path), w["alpha"], w["beta"], w["unk_score_offset"], w["lm_score_boundary"])
               for path, w in zip(paths, MEMBERS)]
    raw = manifest.config(manifest.manifest(), "quartznet-char-3gram")["labels"]
    return ReferenceDecoder(raw, members, precision=precision, hotwords=hotwords, hotword_weight=HOT_WEIGHT)


def _program_ensemble(paths):
    return P.MultiLanguageModel([
        P.LanguageModel(open_ngram_file(path), load_unigram_set_from_arpa(path), alpha=w["alpha"], beta=w["beta"],
                        unk_score_offset=w["unk_score_offset"], score_boundary=w["lm_score_boundary"])
        for path, w in zip(paths, MEMBERS)])


def _spoken(vocab, labels, n, seed):
    """``n`` utterances as (transcript, raw logits), and hotwords the transcripts speak.

    The hotwords: four of the transcripts' words, their first two words as a
    phrase, and a string no LM knows.
    """
    rng = traffic.seeded(seed)
    words = vocab[:300] + data.TRANSCRIPT.split()
    utts = [data.render_utterance(rng, words, labels, False, c) for c in traffic.frame_counts([60, 110], n)]
    spoken = sorted({w for text, _ in utts for w in text.split()})
    first = utts[0][0].split()
    hot = [str(w) for w in np.random.RandomState(seed).choice(spoken, 4, replace=False)] + [" ".join(first[:2]),
                                                                                          "qzxvj"]
    return utts, hot


def test_ensemble_with_hotwords_equals_both_engines_batch(ensemble):
    paths, vocab = ensemble
    ref = _members(paths)
    utts, hot = _spoken(vocab, ref.labels, 3, 5)
    ref = _members(paths, hotwords=hot)
    mats = [m for _, m in utts]
    alphabet = P.Alphabet.build_alphabet(manifest.config(manifest.manifest(), "quartznet-char-3gram")["labels"])
    host = P.BeamSearchDecoderCTC(alphabet, _program_ensemble(paths))
    device = P.TorchBeamSearchDecoderCTC(alphabet, _program_ensemble(paths), device="cpu")
    kw = dict(beam_width=BEAM, hotwords=hot, hotword_weight=HOT_WEIGHT)
    want = [ref.decode(m, beam_width=BEAM) for m in mats]
    words = [m.model.words for m in ref.members]
    assert all(isinstance(b["state"], tuple) and len(b["state"]) == 2 for w in want for b in w)
    assert any(w in ref.hot for beams in want for w in beams[0]["text"].split())  # a hotword is decoded
    for engine, got in (("host", [host.decode_beams(m, **kw) for m in mats]),
                        ("device", device.decode_beams_batch(mats, **kw))):
        pairs = []
        for beams, w in zip(got, want):
            mine = judge.program_output(beams, words)
            assert [b["text"] for b in mine[:3]] == [b["text"] for b in w[:3]], engine
            assert mine[0]["frames"] == w[0]["frames"] and mine[0]["state"] == w[0]["state"], engine
            pairs.append((mine, w))
        numbers = judge.compare(pairs)
        assert numbers["missing"] == 0 and numbers["top_gap"] == 0 and numbers["score_err"] < SCORE_TOL, engine
    # the hotwords move the scores: without them the reference's best differs
    bare = [_members(paths).decode(m, beam_width=BEAM)[0]["lm"] for m in mats]
    assert any(abs(b - w[0]["lm"]) > 1.0 for b, w in zip(bare, want))


def _host_stream(host, chunks, hot):
    beams, lm_cache, p_cache = host.get_starting_state()
    scorer, offset, views = HotwordScorer.build_scorer(hot, weight=HOT_WEIGHT), 0, []
    for i, chunk in enumerate(chunks):
        out = host.partial_decode_beams(chunk, lm_cache, p_cache, beams, offset, beam_width=BEAM,
                                        hotword_scorer=scorer, is_end=i == len(chunks) - 1)
        beams = [Beam.from_lm_beam(b) for b in out]
        offset += chunk.shape[0]
        views.append(out)
    return views


def test_ensemble_with_hotwords_equals_both_engines_stream(ensemble):
    paths, vocab = ensemble
    utts, hot = _spoken(vocab, _members(paths).labels, 2, 7)
    ref = _members(paths, hotwords=hot)
    alphabet = P.Alphabet.build_alphabet(manifest.config(manifest.manifest(), "quartznet-char-3gram")["labels"])
    host = P.BeamSearchDecoderCTC(alphabet, _program_ensemble(paths))
    device = P.TorchBeamSearchDecoderCTC(alphabet, _program_ensemble(paths), device="cpu")
    for _, mat in utts:
        chunks = traffic.chunks(mat, 25)
        want = [judge.reference_view(v) for v in ref.stream(chunks, beam_width=BEAM)]
        state = device.get_starting_state(beam_width=BEAM, hotwords_enabled=True)
        dev_views = [device.partial_decode_beams(state, c, is_end=i == len(chunks) - 1, hotwords=hot,
                                                 hotword_weight=HOT_WEIGHT) for i, c in enumerate(chunks)]
        for engine, views in (("host", _host_stream(host, chunks, hot)), ("device", dev_views)):
            pairs = [(judge.program_view(v), w) for v, w in zip(views, want)]
            for mine, w in pairs:
                assert [(b["text"], b["partial"], b["frames"], b["pframes"]) for b in mine[:3]] == \
                    [(b["text"], b["partial"], b["frames"], b["pframes"]) for b in w[:3]], engine
            numbers = judge.compare(pairs)
            assert numbers["missing"] == 0 and numbers["top_gap"] == 0 and numbers["score_err"] < SCORE_TOL, engine


def test_one_member_without_hotwords_is_the_single_lm_reference(lm):
    """The single LM given as an ArpaModel and the reference's own state shape: bit for bit as before."""
    path, vocab = lm
    raw = _raw_labels("char", vocab)
    model = ArpaModel(str(path))
    single = ReferenceDecoder(raw, model, alpha=0.8, beta=0.5, unk_score_offset=-2.0)
    mats = _inputs(vocab, single.labels, False, n=2, seed=11)
    for m in mats:
        got = single.decode(m, beam_width=BEAM)
        assert all(b["state"] is None or all(isinstance(w, str) for w in b["state"]) for b in got)
        twin = ReferenceDecoder(raw, model, alpha=0.8, beta=0.5, unk_score_offset=-2.0, hotwords=[])
        assert twin.decode(m, beam_width=BEAM) == got
    with pytest.raises(ValueError, match="two or more"):
        ReferenceDecoder(raw, [Member(model)])


def test_the_control_fails_on_the_ensemble_with_hotwords(ensemble):
    paths, vocab = ensemble
    utts, hot = _spoken(vocab, _members(paths).labels, 4, 9)
    ref, low = _members(paths, hotwords=hot), _members(paths, "bf16", hot)
    pairs = [(low.decode(m, beam_width=BEAM), ref.decode(m, beam_width=BEAM)) for _, m in utts]
    numbers = judge.compare(pairs)
    for cell in ("quartznet-char-3gram.dense32", "quartznet-char-3gram.stream"):
        assert not judge.verdict(numbers, manifest.limits(cell)), numbers
