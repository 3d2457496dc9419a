"""The frozen generators: deterministic from the seed, equal to the originals they copy, pinned by digests."""
import hashlib

import numpy as np

from cardbench.harness import data, manifest, traffic
from cardbench.harness.loops import Sample
from cardbench.reference.decoder import normalize_labels

ARPA_SHA256 = "c60d7db7388ebfbba15a05f1a5597c4623ec77b10c702ba9c8dc929f3472b29d"
BPE_SHA256 = "ad73e515fef629ece482f8f0859501e45479994d8a0384173eaea477f180d02f"
BATCH_SHA256 = "d1fd73ed70b2e3d71466430535380b199eecc6777d84c338dc4340c4817ad773"
MIX = dict(generator="batch", rows=3, frames=[40, 70], pool=2)
SEED = 12345678901


def small_arpa(path):
    return data.write_parity_arpa(str(path), 800, 1200, 900, 7)


def test_parity_arpa_digest_and_the_original(tmp_path):
    from pyctcdecode_torch.evaluation import make_parity_arpa

    vocab = small_arpa(tmp_path / "a.arpa")
    assert hashlib.sha256((tmp_path / "a.arpa").read_bytes()).hexdigest() == ARPA_SHA256
    assert make_parity_arpa(str(tmp_path / "b.arpa"), 800, 1200, 900, seed=7) == vocab
    assert (tmp_path / "a.arpa").read_bytes() == (tmp_path / "b.arpa").read_bytes()


def test_bpe_vocabulary_digest_and_the_original(tmp_path):
    import chip_smoke

    vocab = small_arpa(tmp_path / "a.arpa")
    bpe = data.bpe_vocabulary(vocab)
    assert len(bpe) == 128 and len(set(bpe)) == 128
    assert hashlib.sha256("\n".join(bpe).encode()).hexdigest() == BPE_SHA256
    assert bpe == chip_smoke.bpe_vocabulary(vocab)
    index = {lab: i for i, lab in enumerate(bpe)}
    for w in vocab[:300]:
        assert data.split_pieces(w, index) == chip_smoke.split_pieces(w, index)


def test_the_bpe_configuration_holds_the_frozen_pieces():
    cfg = manifest.config(manifest.manifest(), "conformer-bpe128-3gram")
    vocab = data.parity_vocab(np.random.RandomState(cfg["lm"]["seed"]), cfg["lm"]["n_vocab"])
    assert cfg["labels"] == data.bpe_vocabulary(vocab)


def test_batch_traffic_is_deterministic_and_pinned(tmp_path):
    vocab = small_arpa(tmp_path / "a.arpa")
    ctx = traffic.context(vocab[:200], data.LIBRI_LABELS, False, 0.02)
    pool = traffic.make(MIX, SEED, ctx)["pool"]
    again = traffic.make(MIX, SEED, ctx)["pool"]
    h = hashlib.sha256()
    for b, c in zip(pool, again):
        for m, n in zip(b, c):
            assert np.array_equal(m, n) and m.dtype == np.float32
            h.update(m.tobytes())
    assert h.hexdigest() == BATCH_SHA256


def test_every_seed_asks_for_the_same_sizes(tmp_path):
    vocab = small_arpa(tmp_path / "a.arpa")
    ctx = traffic.context(vocab[:200], data.LIBRI_LABELS, False, 0.02)
    sizes = []
    for seed in (1, 2, 2**31 + 5):
        pool = traffic.make(MIX, seed, ctx)["pool"]
        sizes.append(sorted(m.shape[0] for b in pool for m in b))
        assert [sorted(m.shape[0] for m in b) for b in pool] == [[40, 55, 70]] * 2
    assert sizes[0] == sizes[1] == sizes[2]
    mix = dict(generator="stream", streams=3, utterances=4, frames=[290, 540], chunk_s=0.5)
    made = [traffic.make(mix, seed, ctx) for seed in (9, 10)]
    for m in made:
        assert m["kind"] == "stream" and m["chunk_frames"] == 25
        assert all(sorted(u.shape[0] for u in s["utterances"]) == [290, 373, 457, 540] for s in m["streams"])
    # the same arrival times for every seed: offsets spread over one period, then a chunk every period
    dues = [[[next(s["due"]) for _ in range(3)] for s in m["streams"]] for m in made]
    assert dues[0] == dues[1]
    assert dues[0][1][:2] == [0.5 / 3, 0.5 / 3 + 0.5]


def test_the_wav2vec2_configuration_is_the_tokenizers_whole_output():
    """wav2vec2-base-960h's 32 outputs in the tokenizer's order: <pad> the blank, | the word delimiter."""
    cfg = manifest.load_json(manifest.BENCH_DIR / "configs" / "w2v2-char-3gram.json")
    assert len(cfg["labels"]) == 32 and cfg["labels"][:5] == ["<pad>", "<s>", "</s>", "<unk>", "|"]
    columns, is_bpe = normalize_labels(cfg["labels"])
    assert not is_bpe and len(columns) == 32 and columns[0] == "" and columns[4] == " " and columns[3] == "⁇"
    assert sorted(c for c in columns if len(c) == 1 and c.isalpha()) == list("abcdefghijklmnopqrstuvwxyz")
    import pyctcdecode_torch as P

    assert P.Alphabet.build_alphabet(cfg["labels"]).labels == columns


def test_the_quartznet_configuration_reads_as_the_fixture_layout():
    """QuartzNet's 28 labels, the blank appended: the columns of the frozen digests' layout."""
    cfg = manifest.config(manifest.manifest(), "quartznet-char-3gram")
    assert normalize_labels(cfg["labels"]) == (data.LIBRI_LABELS, False)


def test_an_utterance_keeps_the_noise_model():
    rng = np.random.RandomState(0)
    text, mat = data.render_utterance(rng, ["abc", "de"], data.LIBRI_LABELS, False, 60)
    blank = data.LIBRI_LABELS.index("")
    assert mat.shape == (60, 29) and text
    best = mat.argmax(axis=1)
    assert (best[-3:] == blank).all()  # trailing silence
    assert set(" ".join(text.split())) <= set("abcde ")


def test_the_sample_is_seeded_uniform_and_holds_a_longest():
    def draw(seed):
        sample = Sample(4, traffic.seeded(seed, 3))
        for i in range(200):
            sample.offer(("k", i), f"answer {i}", size=i % 7)
        return sample.picks()

    picks = draw(11)
    assert picks == draw(11) and picks != draw(12)
    assert len(picks) == 4 and picks[0][0][1] % 7 == 6  # one of the longest inputs first
    counts = [0] * 200
    for seed in range(400):
        for (_, i), _ in draw(seed)[1:]:
            counts[i] += 1
    early, late = sum(counts[:100]), sum(counts[100:])
    assert abs(early - late) < 0.15 * (early + late) and max(counts) < 25  # early and late answers alike
