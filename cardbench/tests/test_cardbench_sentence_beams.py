"""The readers of ``sentence_beams.batch`` / ``.stream`` and the counters they read.

The program counts, while its tracer is on, the beams its batch replay and
its stream replay return (``replay.beams``) and those whose words hold the
LM's ``<s>`` or ``</s>`` (``replay.sentence_beams``); the build counts the
sentence markers its device trie holds as words (``build.sentence_words``):
two for wav2vec2's labels, none for the labels that cannot spell them.
"""
import pytest

from cardbench import spans as tool
from cardbench.harness import data, manifest
from cardbench.tests.tiny import tiny_bench

SEED = 3_016_000_019
READERS = ("sentence_beams.batch", "sentence_beams.stream")


def _record(kind, counters):
    return dict(kind=kind, program=dict(setup=dict(spans=[], counters={}), window=dict(spans=[], counters=counters),
                                        traced=dict(spans=[], counters={})))


def test_the_readers_take_the_share_of_their_own_kind():
    counters = {"replay.beams": 40, "replay.sentence_beams": 10}
    batch, stream = (manifest.reader(name) for name in READERS)
    assert batch(_record("batch", counters)) == pytest.approx(0.25) and stream(_record("batch", counters)) is None
    assert stream(_record("stream", counters)) == pytest.approx(0.25) and batch(_record("stream", counters)) is None
    assert batch(_record("batch", {"replay.beams": 40})) == 0.0


@pytest.mark.parametrize("kind", ["batch", "stream"])
def test_the_readers_read_nothing_without_the_counters(kind):
    for name in READERS:
        assert manifest.reader(name)(dict(kind=kind, lm_build_s=1.0)) is None
        assert manifest.reader(name)(_record(kind, {"steps.active": 3})) is None


def test_the_configurations_sentence_words(tmp_path):
    """``build.sentence_words`` of each configuration of the benchmark, over a small LM with the markers."""
    import pyctcdecode_torch as P
    from pyctcdecode_torch.utils import profiling

    arpa = str(tmp_path / "small.arpa")
    data.write_parity_arpa(arpa, 300, 400, 300, 7)
    bench = manifest.manifest()
    counts = {}
    for c in bench["configs"]:
        with profiling.tracing() as tr:
            P.build_ctcdecoder(manifest.config(bench, c["name"])["labels"], arpa, device="cpu")
        counts[c["name"]] = tr.counters()["build.sentence_words"]
    assert counts == {name: 2 if name == "w2v2-char-3gram" else 0 for name in counts} and len(counts) >= 3


@pytest.mark.parametrize("kind", ["batch", "stream"])
def test_a_traced_w2v2_run_reads_the_share(tmp_path, monkeypatch, kind):
    w2v2 = manifest.load_json(manifest.BENCH_DIR / "configs" / "w2v2-char-3gram.json")["labels"]
    bench = tiny_bench(tmp_path, monkeypatch, "char", kind)
    path = tmp_path / "configs" / "tiny.json"
    cfg = manifest.load_json(path)
    cfg["labels"] = w2v2
    path.write_text(manifest.json.dumps(cfg))
    out = tool.run(bench, "tiny.mix", SEED, 0.5, "cpu", cost_calls=1, cost_s=0.2, cache_dir=tmp_path / ".cache")
    counters = out["counters"]["window"]
    assert counters["replay.beams"] > 0 and 0 <= counters["replay.sentence_beams"] <= counters["replay.beams"]
    share = manifest.reader(f"sentence_beams.{kind}")(_record(kind, counters))
    assert share == counters["replay.sentence_beams"] / counters["replay.beams"]
