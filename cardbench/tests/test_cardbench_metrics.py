"""The metric arithmetic on synthetic rows and spans, and the readers found by name."""
import math

import pytest

from cardbench.harness import manifest, trace, work
from cardbench.harness.loops import percentile


def test_union_merges_overlaps_and_keeps_gaps():
    assert trace.union([(3, 4), (0, 1), (0.5, 2), (2, 2.5)]) == [(0, 2.5), (3, 4)]
    assert trace.union([]) == []


def test_summary_busy_idle_and_gap_names():
    rows = [("k1", 1.0, 2.0), ("k2", 1.5, 3.0), ("k1", 5.0, 6.0), ("pre", -1.0, -0.5)]
    ranges = [(trace.WINDOW, 0.0, 10.0), ("decode_beams_batch", 0.5, 6.5), ("prep", 6.5, 7.0)]
    s = trace.summarize(rows, ranges)
    assert s["busy_s"] == pytest.approx(3.0) and s["window_s"] == pytest.approx(10.0)
    assert s["device_rows"] == 3  # the pre-roll before the window is left out
    assert s["device_ops"][0] == ["k1", pytest.approx(2.0)]
    idle = dict(s["idle_gaps"])
    # gaps: [0,1] and [3,5] inside the call's span ([0,1] has its middle at 0.5), [6,10] from 6 to the end
    assert idle["decode_beams_batch >=20us"] == pytest.approx(3.0)
    assert idle["harness >=20us"] == pytest.approx(4.0)  # [6, 10]: its middle, 8, lies in no span
    assert sum(idle.values()) == pytest.approx(s["window_s"] - s["busy_s"])


def test_summary_without_a_window_reads_nothing():
    assert trace.summarize([("k", 0.0, 1.0)], [("prep", 0.0, 1.0)]) is None


def _batch_record(**over):
    rec = dict(kind="batch", lm_build_s=21.5, setup_s=30.0, peak_bytes=2.0e8,
               window=dict(start=10.0, end=30.5, audio_s=4100.0, calls=41),
               trace=dict(busy_s=0.8, window_s=1.0, device_rows=400_000),
               traced=dict(calls=2, steps=1000, row_steps=26_000),
               shape=dict(vocab=29, beam=100, letters=27, orders=[3], hotwords=False))
    rec.update(over)
    return rec


def test_batch_readers():
    rec = _batch_record()
    read = manifest.reader
    assert read("audio_s_per_s")(rec) == pytest.approx(4100.0 / 20.5)  # up to the last return
    assert read("step_device_ms.batch")(rec) == pytest.approx(0.8)
    assert read("ops_per_step.batch")(rec) == pytest.approx(400.0)
    assert read("idle_share.batch")(rec) == pytest.approx(1.0 - (0.8 / 2) / 0.5)  # 0.5 s a call untraced
    assert read("peak_mem_gb")(rec) == pytest.approx(0.2)
    assert read("setup_s")(rec) == 30.0 and read("lm_build_s")(rec) == 21.5
    w = work.row_step(29, 100, 27, [3])
    assert w["bytes"] == 4 * 29 + 2 * 100 * 28 + 100 * 4 + 100 * 27 * 4 + 100 * 3 * 16
    want = 100 * 26_000 * w["bytes"] / work.PEAK_BYTES_S / 0.8
    assert read("step_roofline.batch")(rec) == pytest.approx(want)
    for name in ("chunk_p95_ms", "chunk_service_p50_ms.stream", "chunk_device_ms.stream", "idle_share.stream"):
        assert read(name)(rec) is None  # a batch run has nothing for the stream's readers


def test_readers_find_nothing_without_a_trace():
    rec = _batch_record(trace=None, peak_bytes=0)
    for name in ("step_device_ms.batch", "ops_per_step.batch", "step_roofline.batch", "idle_share.batch",
                 "peak_mem_gb"):
        assert manifest.reader(name)(rec) is None


def test_stream_readers_p95_from_due_times():
    lat = [float(i) for i in range(1, 101)]  # ms from due to return
    rec = dict(kind="stream", lm_build_s=20.0, setup_s=25.0, peak_bytes=1e8, latency_ms=lat,
               window=dict(start=0.0, end=20.0, chunks=800),
               service_ms=[10.0, 20.0, 30.0], trace=dict(busy_s=0.3, window_s=1.2, device_rows=10),
               traced=dict(chunks=60))
    read = manifest.reader
    assert read("chunk_p95_ms")(rec) == pytest.approx(95.05)
    assert read("chunk_service_p50_ms.stream")(rec) == pytest.approx(20.0)
    assert read("chunk_device_ms.stream")(rec) == pytest.approx(5.0)
    assert read("idle_share.stream")(rec) == pytest.approx(1.0 - 0.005 * 800 / 20.0)  # 5 ms a chunk
    assert read("audio_s_per_s")(rec) is None


def test_percentile_is_linear_and_empty_reads_nothing():
    assert percentile([1.0, 2.0], 50) == 1.5
    assert percentile([], 95) is None
    assert math.isclose(percentile(list(range(21)), 95), 19.0)


def test_least_seconds_takes_the_larger_bound():
    t = work.least_seconds(10, 29, 100, 27, [3])
    w = work.row_step(29, 100, 27, [3])
    assert t == pytest.approx(max(10 * w["bytes"] / 3.35e12, 10 * w["ops"] / 67e12))


def test_trie_letters_count_what_each_label_adds_to_the_word():
    assert work.trie_letters([" ", "a", "b", "'", ""], False) == 3
    assert work.trie_letters(["", "<s>", "</s>", "⁇", " ", "a"], False) == 3 + 4 + 1 + 1
    assert work.trie_letters(["▁⁇▁", "▁", "a", "▁ab", "cde", ""], True) == 1 + 0 + 1 + 2 + 3


@pytest.mark.parametrize("config,vocab,letters,nbytes,ops", [
    ("quartznet-char-3gram", 29, 27, 21716.0, 23200.0),
    ("conformer-bpe128-3gram", 129, 273, 120516.0, 103200.0),
    ("w2v2-char-3gram", 32, 35, 24928.0, 25600.0),
])
def test_row_step_of_the_cells_shapes_is_pinned(config, vocab, letters, nbytes, ops):
    """The five cells' step (one 3-gram, no hotwords, beam 100) keeps the bytes and operations it had."""
    from cardbench.reference.decoder import normalize_labels

    cfg = manifest.config(manifest.manifest(), config)
    columns, is_bpe = normalize_labels(cfg["labels"])
    assert (len(columns), work.trie_letters(columns, is_bpe)) == (vocab, letters)
    assert [recipe["order"] for recipe, _ in manifest.lm_members(cfg)] == [3]
    assert work.row_step(vocab, 100, letters, [3]) == dict(bytes=nbytes, ops=ops)
    assert work.row_step(vocab, 100, letters, [3], hotwords=False) == dict(bytes=nbytes, ops=ops)


def test_row_step_counts_each_member_and_the_hotword_trie():
    one = work.row_step(29, 100, 27, [3])["bytes"]
    two = work.row_step(29, 100, 27, [3, 2])["bytes"]
    # member B: one context word more in the state (read and written), its trie's slots, 2 n-gram entries a beam
    assert two - one == 2 * 100 * 4 * 1 + 100 * 27 * 4 + 100 * 2 * 16
    assert work.row_step(29, 100, 27, [3, 2], hotwords=True)["bytes"] - two == 100 * 27 * 4
    assert work.row_step(29, 100, 27, [3, 2], hotwords=True)["ops"] == work.row_step(29, 100, 27, [3])["ops"]
