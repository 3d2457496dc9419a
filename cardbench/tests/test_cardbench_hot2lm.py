"""The quartznet-char-hot2lm configuration as committed, and its cell at a tiny size on the CPU.

The configuration (two parity 3-gram members in a ``MultiLanguageModel``),
the mix ``dense32-hot28`` (28 hotwords at weight 10 in every call) and the
cell's limits are read as committed. At a tiny size (the LM counts cut as
``tiny.py`` cuts them, member B at half of member A's bigrams and
trigrams, a beam of 8, and the speakers' words cut to 30 so that the
transcript's phrases, two of the hotwords, are spoken often)
the program's device engine on the CPU and its host engine decode a few
rows of the mix's batches, each held against ``cardbench/reference`` on
the top beam's text, word frames and tuple LM state, with scores within
the committed ``score_err`` limit. The program called without its
hotwords, and with member B's alpha and beta swapped, fails the committed
limits. The cell's yardstick is pinned.
"""
import json
import os

import pytest

from cardbench.harness import data, judge, manifest, runner, traffic
from cardbench.harness.work import row_step
from cardbench.tests.tiny import LM, LM_HALF

CONFIG = "quartznet-char-hot2lm"
CELL = "quartznet-char-hot2lm.dense32-hot28"
BEAM = 8
ROWS = 3  # rows of the mix's first batch decoded here
SEED = 3_022_000_031


def _committed():
    bench = manifest.manifest()
    return bench, manifest.config(bench, CONFIG), manifest.mix("dense32-hot28"), manifest.limits(CELL)


def test_the_committed_configuration_mix_and_cell():
    bench, cfg, mix, limits = _committed()
    char = manifest.config(bench, "quartznet-char-3gram")
    assert manifest.config_problems(CONFIG, cfg) == []
    assert next(c for c in bench["configs"] if c["name"] == CONFIG)["reduced"] == cfg["reduced"] == []
    for key in ("labels", "frame_s", "search", "corpus"):
        assert cfg[key] == char[key], key
    (a, wa), (b, wb) = manifest.lm_members(cfg)
    assert a == char["lm"] and wa == char["decoder"]  # member A is the char cell's LM: one cached ARPA for both
    assert b == dict(a, n_bigrams=750_000, n_trigrams=550_000)
    assert wb == dict(alpha=0.3, beta=2.0, unk_score_offset=-6.0, lm_score_boundary=False)
    assert mix == dict(manifest.mix("dense32"), decode=mix["decode"])
    hot = mix["decode"]["hotwords"]
    assert mix["decode"]["hotword_weight"] == 10.0 and len(hot) == len(set(hot)) == 28
    words, phrases, unknown = hot[:24], hot[24:26], hot[26:]
    assert all(len(w.split()) == 1 for w in words)
    transcript = data.TRANSCRIPT
    assert all(len(p.split()) == 2 and f" {p} " in f" {transcript} " for p in phrases)
    assert all(len(w) == 13 for w in unknown)  # the LM's words have 2-11 letters (parity_vocab)
    assumed = next(s for s in cfg["assumed"] if "hotwords" in s)
    assert all(w in assumed for w in hot)
    assert limits == manifest.limits("quartznet-char-3gram.dense32")
    entry = manifest.cell(bench, CELL)
    assert (entry["config"], entry["traffic"], entry["chips"]) == (CONFIG, "dense32-hot28", 1)
    batch_lists = [m for m in bench["end_to_end"] + bench["per_layer"]
                   if "quartznet-char-3gram.dense32" in m.get("workloads", ())]
    assert {m["name"] for m in batch_lists if CELL not in m["workloads"]} == {"lm_read_s", "lm_tables_s"}
    assert [m["name"] for m in bench["per_layer"] if m.get("workloads") == [CELL]] == ["member_load_s"]


def test_the_cells_yardstick():
    assert row_step(29, 100, 27, [3, 3], hotwords=True) == dict(bytes=49716.0, ops=23200.0)


@pytest.fixture(scope="module")
def cell(tmp_path_factory):
    """The cell over the committed files, its LM counts, beam and speakers' words cut; and a few rows."""
    tmp = tmp_path_factory.mktemp("hot2lm")
    _, cfg, mix, limits = _committed()
    for sub in ("traffic", "limits", "configs"):
        (tmp / sub).mkdir()
    for sub in ("metrics", "generators", "lms"):
        os.symlink(manifest.BENCH_DIR / sub, tmp / sub)
    for member, counts in zip(cfg["members"], (LM, LM_HALF)):
        member["lm"].update(counts)
    cfg["search"]["beam_width"] = BEAM
    cfg["corpus"]["words"] = 30
    (tmp / "configs" / "tiny.json").write_text(json.dumps(cfg))
    (tmp / "traffic" / "dense32-hot28.json").write_text(json.dumps(mix))
    (tmp / "limits" / "tiny.dense32-hot28.json").write_text(json.dumps(limits))
    bench = manifest.manifest()
    bench["configs"] = [dict(name="tiny", source="test", file=str(tmp / "configs" / "tiny.json"), reduced=[],
                             why="test")]
    bench["workloads"] = [dict(name="tiny.dense32-hot28", config="tiny", traffic="dense32-hot28", chips=1,
                               why="test")]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(manifest, "BENCH_DIR", tmp)
        c = runner.Cell(bench, "tiny.dense32-hot28", "cpu", cache_dir=tmp / ".cache")
        rows = traffic.make(c.mix, SEED, c.ctx)["pool"][0][:ROWS]
        c.reference("f64")  # reads the ARPA files
        yield c, rows


def _decode(dec, rows, cell, **kw):
    s = cell.search
    kw = dict(dict(beam_width=s["beam_width"], beam_prune_logp=s["beam_prune_logp"],
                   token_min_logp=s["token_min_logp"]), **kw)
    return dec.decode_beams_batch(rows, **kw)


@pytest.fixture(scope="module")
def want(cell):
    c, rows = cell
    ref, s = c.reference("f64"), c.search
    return [ref.decode(m, beam_width=s["beam_width"], prune_logp=s["beam_prune_logp"],
                       token_min_logp=s["token_min_logp"]) for m in rows]


def test_the_tiny_cell_speaks_its_hotwords(cell, want):
    c, rows = cell
    hot = {w for p in c.hot["hotwords"] for w in p.split()}
    assert any(hot & set(beams[0]["text"].split()) for beams in want)
    assert c.shape() == dict(vocab=29, beam=BEAM, letters=27, orders=[3, 3], hotwords=True)


@pytest.mark.parametrize("engine", ["torch", "host"])
def test_both_engines_equal_the_reference(cell, want, engine):
    c, rows = cell
    if engine == "torch":
        got = _decode(c.decoder, rows, c, **c.hot)
    else:
        host = c.build(engine="host")
        s = c.search
        got = [host.decode_beams(m, beam_width=s["beam_width"], beam_prune_logp=s["beam_prune_logp"],
                                 token_min_logp=s["token_min_logp"], **c.hot) for m in rows]
    pairs = []
    for beams, w in zip(got, want):
        mine = judge.program_output(beams, c.words())
        top = mine[0]
        assert (top["text"], top["frames"], top["state"]) == (w[0]["text"], w[0]["frames"], w[0]["state"])
        assert isinstance(top["state"], tuple) and len(top["state"]) == 2
        pairs.append((mine, w))
    numbers = judge.compare(pairs)
    assert numbers["score_err"] <= c.limits["score_err"] and judge.verdict(numbers, c.limits), numbers


def _without_hotwords(c, rows):
    return _decode(c.decoder, rows, c)


def _member_b_weights_swapped(c, rows):
    b = c.decoder._lm_members[1]
    b.alpha, b.beta = b.beta, b.alpha
    try:
        return _decode(c.decoder, rows, c, **c.hot)
    finally:
        b.alpha, b.beta = b.beta, b.alpha


@pytest.mark.parametrize("fault", [_without_hotwords, _member_b_weights_swapped])
def test_a_planted_fault_fails_the_committed_limits(cell, want, fault):
    c, rows = cell
    got = fault(c, rows)
    numbers = judge.compare([(judge.program_output(beams, c.words()), w) for beams, w in zip(got, want)])
    assert not judge.verdict(numbers, c.limits), numbers
