"""The plain reference against the program at tiny sizes on the CPU, and the control that must fail.

The reference decodes the same raw logits over its own read of the same
ARPA text; its beams must carry what the program's carry (texts, word
frames, LM states; scores within float32 rounding). The control, the
reference computed in bfloat16, put in the program's place, must fail the
limits of the cells (``cardbench/limits``).
"""
import pytest

from cardbench.harness import data, judge, manifest, traffic
from cardbench.reference.arpa import ArpaModel
from cardbench.reference.decoder import ReferenceDecoder, to_bf16

import pyctcdecode_torch as P

BEAM = 16
SCORE_TOL = 1e-4


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
