"""Decode counters (``collect_stats``): the port against the JAX engine, integer for integer.

``decode_beams_batch(collect_stats=True)`` returns ``(results, stats)``, one
``{name: int}`` dict per utterance (``engine.stats_fields``). The same
inputs (numpy, seeded) go through ``TorchBeamSearchDecoderCTC(device="cpu")``
and the JAX ``TPUBeamSearchDecoderCTC``: every counter must be equal, and
the port's results with the counters on must equal its results without
them. The batch is the timeline tests' (merges, window kills, blank runs);
the beam is narrow so that the window and the history prune both fire.
"""
import numpy as np
import pytest

import pyctcdecode_torch as P
from pyctcdecode_torch.engine import EngineConfig, stats_fields
from pyctcdecode_torch.models.ngram import open_ngram_file
from pyctcdecode_tpu import Alphabet as JAlphabet
from pyctcdecode_tpu import LanguageModel as JLanguageModel
from pyctcdecode_tpu import TPUBeamSearchDecoderCTC
from pyctcdecode_tpu.engine import EngineConfig as JEngineConfig
from pyctcdecode_tpu.engine import stats_fields as j_stats_fields
from pyctcdecode_tpu.models.language_model import MultiLanguageModel as JMultiLanguageModel
from pyctcdecode_tpu.models.ngram import NGramModel as JNGramModel

from .helpers import SAMPLE_LABELS
from .torch_cases import (
    ARPA,
    ARPA_2GRAM,
    LM_WORDS,
    UNIGRAMS,
    assert_same_beams,
    piece_logits,
    piece_vocabulary,
    word_logits,
)
from .torch_cases import one_torch_thread  # noqa: F401  (autouse fixture)

BEAM = 8
BATCH = [word_logits(7, 31), word_logits(8, 12), word_logits(9, 40), word_logits(10, 25)]
BATCH[2][5:15, -1] += 14.0  # a blank run: the collapse drops all but its first frame
PIECES = piece_vocabulary(LM_WORDS)


@pytest.fixture(scope="module")
def decoders(tmp_path_factory):
    """(JAX, torch) decoder pairs by name, built on first use."""
    root = tmp_path_factory.mktemp("lm")
    paths = {}
    for name, text in (("3", ARPA), ("2", ARPA_2GRAM)):
        paths[name] = str(root / f"bb{name}.arpa")
        with open(paths[name], "w") as fh:
            fh.write(text)
    cache = {}

    def get(name):
        if name not in cache:
            labels = PIECES if name == "bpe" else SAMPLE_LABELS
            ja, pa = JAlphabet.build_alphabet(labels), P.Alphabet.build_alphabet(labels)
            if name == "none":
                jlm = plm = None
            elif name == "two":
                kw = dict(alpha=0.3, beta=2.0)
                jlm = JMultiLanguageModel([JLanguageModel(JNGramModel.from_file(paths["3"]), UNIGRAMS),
                                           JLanguageModel(JNGramModel.from_file(paths["2"]), UNIGRAMS, **kw)])
                plm = P.MultiLanguageModel([P.LanguageModel(open_ngram_file(paths["3"]), UNIGRAMS),
                                            P.LanguageModel(open_ngram_file(paths["2"]), UNIGRAMS, **kw)])
            else:
                jlm = JLanguageModel(JNGramModel.from_file(paths["3"]), UNIGRAMS)
                plm = P.LanguageModel(open_ngram_file(paths["3"]), UNIGRAMS)
            cache[name] = (TPUBeamSearchDecoderCTC(ja, jlm), P.TorchBeamSearchDecoderCTC(pa, plm, device="cpu"))
        return cache[name]

    return get


def _both(decoders, name, batch, **kw):
    """Port results and stats with the counters on, JAX stats, and the port's results without them."""
    jdec, pdec = decoders(name)
    p_res, p_stats = pdec.decode_beams_batch(batch, beam_width=BEAM, collect_stats=True, **kw)
    _, j_stats = jdec.decode_beams_batch(batch, beam_width=BEAM, collect_stats=True, **kw)
    plain = pdec.decode_beams_batch(batch, beam_width=BEAM, **kw)
    return p_res, p_stats, j_stats, plain


CASES = {
    "dense, no LM": ("none", {}),
    "dense, one LM": ("lm", {}),
    "dense, two members": ("two", {}),
    "dense, hotwords": ("lm", dict(hotwords=["bunny", "gun"], hotword_weight=5.0)),
    "dense, K auto": ("lm", dict(max_tokens_per_frame="auto")),
    "dense, top_n 2, no history prune": ("lm", dict(top_n=2, prune_history=False)),
    "timeline, collapse, bucketing": ("lm", dict(token_chunking=3, blank_collapse=True, length_bucketing=2)),
    "timeline, two members, hotwords": ("two", dict(token_chunking=2, hotwords=["bunny"])),
}


@pytest.mark.parametrize("case", list(CASES))
def test_counters_equal_jax_and_results_unchanged(decoders, case):
    name, kw = CASES[case]
    p_res, p_stats, j_stats, plain = _both(decoders, name, BATCH, **kw)
    assert p_stats == j_stats
    assert len(p_stats) == len(BATCH)
    assert all(type(v) is int for st in p_stats for v in st.values())
    for got, want in zip(p_res, plain):
        assert_same_beams(want, got, tol=0.0)
    st = p_stats[2]
    assert st["beams_alive"] > 0 and st["candidates_valid"] >= st["beams_alive"]
    if name != "none":
        assert st["probe_queries"] == (2 if name == "two" else 1) * st["beams_alive"]


def test_bpe_counters_equal_jax(decoders):
    """A BPE alphabet with its forced break mid-utterance."""
    labels = decoders("bpe")[1]._alphabet.labels
    batch = [piece_logits(s, labels, 5) for s in range(3)]
    p_res, p_stats, j_stats, plain = _both(decoders, "bpe", batch)
    assert p_stats == j_stats
    for got, want in zip(p_res, plain):
        assert_same_beams(want, got, tol=0.0)


def test_counters_fire_and_timeline_rates_read_as_dense(decoders):
    """The counters move on this batch; the timeline's frame-shaped counters equal the dense ones.

    (The inline 3-gram is too small for trigram hits, and no two beams of
    this batch share a history, so ``probe_hits_o3`` and ``history_pruned``
    stay 0 here; the cases above hold them against JAX all the same.)

    The JAX package's ``test_stats_timeline_matches_dense``: work counters
    sum over chunks (at least the dense per-frame counts), frame-shaped
    counters count each frame's last chunk only.
    """
    _, dense, _, _ = _both(decoders, "lm", BATCH)
    _, tl, _, _ = _both(decoders, "lm", BATCH, token_chunking=2)
    for name in stats_fields(EngineConfig(BEAM, 8, 8, True, orders=(3,))):
        if name not in ("history_pruned", "probe_hits_o3"):
            assert sum(st[name] for st in dense) > 0, name
    for st, dst, mat in zip(tl, dense, BATCH):
        assert st["frames"] == dst["frames"] == mat.shape[0]
        for key in ("selected_alive", "history_pruned", "words_committed", "candidates_valid"):
            assert st[key] == dst[key], key
        assert st["beams_alive"] >= dst["beams_alive"]
        assert st["probe_queries"] >= dst["probe_queries"]
        for key in ("probe_hits_o1", "probe_hits_o2", "probe_hits_o3"):
            assert 0 <= st[key] <= st["probe_queries"]


def test_field_names_match_jax():
    for orders in ((), (3,), (3, 2), (1,)):
        t_cfg = EngineConfig(8, 8, 8, True, orders=orders, collect_stats=True)
        j_cfg = JEngineConfig(8, 8, 8, False, bool(orders), max(orders, default=1), True,
                              orders=orders, collect_stats=True)
        assert stats_fields(t_cfg) == j_stats_fields(j_cfg)


def test_pipelined_call_refuses_stats(decoders):
    _, pdec = decoders("none")
    with pytest.raises(ValueError, match="collect_stats"):
        next(pdec.decode_beams_batches([BATCH], collect_stats=True))


def test_counters_off_issue_no_extra_ops(decoders):
    """With the counters off the state carries no plane for them and the outputs hold none."""
    from pyctcdecode_torch.engine import make_decode_fn

    _, pdec = decoders("lm")
    cfg = pdec._engine_cfg(BEAM, 8, True, False)
    logp = np.log(np.full((1, 3, 8), 1 / 8, dtype=np.float32))
    import torch

    out = make_decode_fn(cfg, pdec._tabs)(torch.as_tensor(logp), torch.tensor([3]),
                                          pdec._params_vector(-5.0, -10.0), pdec._start_ctx(None))
    assert "stats" not in out
    on = make_decode_fn(dict_cfg := pdec._engine_cfg(BEAM, 8, True, False, collect_stats=True), pdec._tabs)(
        torch.as_tensor(logp), torch.tensor([3]), pdec._params_vector(-5.0, -10.0), pdec._start_ctx(None))
    assert tuple(on["stats"].shape) == (1, len(stats_fields(dict_cfg)))
    assert int(on["stats"][0, 0]) == 3
    assert np.array_equal(out["paths"].numpy(), on["paths"].numpy())
