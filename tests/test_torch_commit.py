"""``commit_words``: the engine step's word commit, held on the CPU.

On CPU tensors the wrapper runs its plain twin (``commit_words_ref``, the
PyTorch composition the step ran before the kernel), and the CUDA kernel is
held to that twin on the card (``test_torch_kernels_cuda.py``). Here the twin
is held, on small hand-made beam states, to the JAX package: to
``lm_score_words_jnp`` (one member, the raw score and the out-state) and to
the JAX engine's ``_commit_quantities`` (every case): orders 2, 3 and 4,
every context length, OOV words with and without a unigram list, two
members, hotwords, KenLM-hash tables, the decode counters' hit masks, and
beams with no partial word, which keep their state. The last tests pin the
engine's choice between the kernel and the composition.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyctcdecode_torch import engine as tengine
from pyctcdecode_torch.alphabet import Alphabet as TAlphabet
from pyctcdecode_torch.constants import LOG_BASE_CHANGE_FACTOR
from pyctcdecode_torch.models import device_tables as tdt
from pyctcdecode_torch.models.language_model import LanguageModel as TLanguageModel
from pyctcdecode_torch.models.ngram import open_ngram_file
from pyctcdecode_torch.ops import commit as tc
from pyctcdecode_torch.ops.tokens import build_token_arrays as t_tokens
from pyctcdecode_tpu import engine as jengine
from pyctcdecode_tpu.alphabet import Alphabet as JAlphabet
from pyctcdecode_tpu.models import device_tables as jdt
from pyctcdecode_tpu.models.language_model import LanguageModel as JLanguageModel
from pyctcdecode_tpu.models.ngram import NGramModel as JNGramModel
from pyctcdecode_tpu.ops.tokens import build_token_arrays as j_tokens

from .helpers import SAMPLE_LABELS
from .torch_cases import ARPA, ARPA_2GRAM, UNIGRAMS, kenlm64_fp_tables
from .torch_cases import one_torch_thread  # noqa: F401  (autouse fixture)

# The test 3-gram grown to a 4-gram: two 4-grams whose prefixes and suffixes are all present.
ARPA_4GRAM = (
    ARPA.replace("ngram 3=4\n", "ngram 3=5\nngram 4=2\n")
    .replace("-0.1\t<s> bugs bunny\n", "-0.1\t<s> bugs bunny\t-0.15\n")
    .replace("-0.2\tbugs bunny </s>\n", "-0.2\tbugs bunny </s>\t0\n")
    .replace("-0.3\tsunny bun buns\n", "-0.3\tsunny bun buns\t0\n")
    .replace("-0.25\t<s> bunny bunny\n", "-0.25\t<s> bunny bunny\t-0.05\n-0.35\tbunny bunny bunny\t-0.1\n")
    .replace("\\end\\", "\\4-grams:\n-0.05\t<s> bugs bunny </s>\n-0.12\t<s> bunny bunny bunny\n\n\\end\\")
)
ARPAS = {2: ARPA_2GRAM, 3: ARPA, 4: ARPA_4GRAM}
N, B, ROW_W = 2, 24, 6  # utterances, beams, words of a hand-made trie row
HOT_WEIGHT = 7.5


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """Per order: the torch DeviceLM, the JAX DeviceLM and the parsed n-grams of one ARPA model."""
    root = tmp_path_factory.mktemp("lm")
    out = {}
    for order, text in ARPAS.items():
        path = root / f"lm{order}.arpa"
        path.write_text(text)
        tlm = TLanguageModel(open_ngram_file(str(path), backend="python"), UNIGRAMS)
        jlm = JLanguageModel(JNGramModel.from_file(str(path)), UNIGRAMS)
        tdlm = tdt.build_device_lm(tlm, t_tokens(TAlphabet.build_alphabet(SAMPLE_LABELS)))
        jdlm = jdt.build_device_lm(jlm, j_tokens(JAlphabet.build_alphabet(SAMPLE_LABELS)))
        assert tdlm.order == order == jdlm.order
        out[order] = (tdlm, jdlm, tlm.ngram_model.tables)
    return out


def kenlm_tables(tdlm, tables_py):
    """The same model with its n-gram tables keyed by KenLM's 64-bit chain (``kenlm64``)."""
    fp = kenlm64_fp_tables(tables_py.ngrams, tdlm.order)
    assert all(t.hash_mode == "kenlm64" for t in fp)
    return dataclasses.replace(tdlm, fp_tables=fp)


def member_planes(tdlm, tables_py, rng, nb):
    """One member's hand-made beam planes: contexts of every length, committed words, trie rows.

    Words and contexts come from the model's own n-grams (so probes hit at
    every order), some words are swapped for random ids; a fifth of the
    beams' nodes are not vocabulary words (the word is ``<unk>``) and a fifth
    of the vocabulary words are not in the unigram list.
    """
    w = tdlm.order - 1
    keys = [k for n in range(1, tdlm.order + 1) for k in tables_py.ngrams[n - 1]]
    n_vocab = tdlm.uni.shape[0]
    ctx = np.full((nb, w), -1, dtype=np.int64)
    ctx_len = np.arange(nb, dtype=np.int64) % (w + 1)  # every length 0 .. w
    wid = np.zeros(nb, dtype=np.int64)
    bo = np.zeros((nb, w), dtype=np.float32)
    for q in range(nb):
        key = keys[rng.randint(len(keys))]
        history = list(rng.randint(0, n_vocab, size=w)) + list(key[:-1])
        k = int(ctx_len[q])
        if k:
            ctx[q, w - k :] = history[len(history) - k :]
        wid[q] = key[-1] if rng.rand() < 0.85 else rng.randint(0, n_vocab)
        bo[q] = tdt.context_suffix_backoffs(tdlm, ctx[q, w - k :])
    in_vocab = rng.rand(nb) < 0.8
    flags = np.where(in_vocab, tdlm.BIT_IN_VOCAB, 0) | np.where(rng.rand(nb) < 0.8, tdlm.BIT_UNI_WORD, 0)
    flags |= np.where(rng.rand(nb) < 0.5, tdlm.BIT_UNI_PREFIX, 0)
    row = rng.randint(-(2**31), 2**31 - 1, size=(nb, ROW_W)).astype(np.int32)
    row[:, -1] = np.where(in_vocab, wid, rng.randint(0, n_vocab, size=nb))
    row[:, -2] = (tdlm.uni[wid, 2] > 0.5).astype(np.int32)
    row[:, -4] = tdlm.uni[wid, 0].view(np.int32)
    row[:, -3] = tdlm.uni[wid, 1].view(np.int32)
    return {"ctx": ctx, "ctx_len": ctx_len, "ctx_bo": bo, "p_flags": flags.astype(np.int64), "row": row}


def beam_state(rng, members, hot):
    """Common planes ``[N * B]`` (a quarter of the beams hold no partial word) and each member's."""
    nb = N * B
    state = {
        "text_lo": rng.randint(0, 2**32, size=nb, dtype=np.int64),
        "text_hi": rng.randint(0, 2**32, size=nb, dtype=np.int64),
        "p_lo": rng.randint(0, 2**32, size=nb, dtype=np.int64),
        "p_hi": rng.randint(0, 2**32, size=nb, dtype=np.int64),
        "p_len": np.where(rng.rand(nb) < 0.25, 0, rng.randint(1, 6, size=nb)).astype(np.int64),
        "fused": rng.randn(nb).astype(np.float32),
    }
    if hot:
        state["h_bits"] = np.where(rng.rand(nb) < 0.5, tdt.HOT_WORD_BIT, 0) | rng.randint(0, 1 << 20, size=nb)
    for i, planes in enumerate(members):
        for key in ("ctx", "ctx_len", "ctx_bo", "p_flags"):
            state[f"{key}{i}"] = planes[key]
    return state


def params(n_lms, seed):
    """The engine's parameter vector: token_min_logp, beam_prune_logp, hot_weight, then per member."""
    rng = np.random.RandomState(seed)
    vec = [-5.0, -10.0, HOT_WEIGHT]
    for _ in range(n_lms):
        vec += [float(rng.uniform(0.3, 1.5)), float(rng.uniform(-1.0, 2.0)), float(rng.uniform(-12.0, -4.0)), 1.0]
    return np.asarray(vec, dtype=np.float32)


def torch_commit(tdlms, state, rows, vec, hot, stats, on_device_params=False, fn=None):
    """The wrapper (the twin on these CPU tensors) on ``[N, B]`` planes."""
    cfg = tengine.EngineConfig(beam_width=B, vocab_size=len(SAMPLE_LABELS), k_tokens=len(SAMPLE_LABELS),
                               prune_history=False, use_hotwords=hot,
                               orders=tuple(d.order for d in tdlms), collect_stats=stats)
    prm = tengine._params_dict(cfg, torch.as_tensor(vec) if on_device_params else vec)
    lms = [d.as_device("cpu") for d in tdlms]
    tstate = {k: torch.as_tensor(v).reshape((N, B) + v.shape[1:]) for k, v in state.items()}
    trows = [torch.as_tensor(r).reshape(N, B, ROW_W) for r in rows]
    return (fn or tc.commit_words)(lms, prm, tstate, trows, hot, stats)


def jax_dev(jdlm, has_unigrams=None):
    """The JAX engine's table dict of a member: its device arrays and its static fields."""
    dev = dict(jdlm.as_device())
    dev["fp"] = [dict(tab, hash_mode="fnv") for tab in dev["fp"]]
    dev.update(unk_id=jdlm.unk_id, unk_prob10=np.float32(jdlm.unk_prob10),
               has_unigrams=jdlm.has_unigrams if has_unigrams is None else has_unigrams)
    return dev


def jax_commit(jdlms, state, rows, vec, hot, stats, has_unigrams=None):
    """The JAX engine's ``_commit_quantities`` on the same beams, flattened to ``[N * B]``."""
    orders = tuple(d.order for d in jdlms)
    cfg = jengine.EngineConfig(beam_width=N * B, vocab_size=len(SAMPLE_LABELS), k_tokens=len(SAMPLE_LABELS),
                               is_bpe=False, use_lm=True, order=max(orders), prune_history=False,
                               use_hotwords=hot, orders=orders, collect_stats=stats)
    devs = [jax_dev(d, has_unigrams) for d in jdlms]
    nb, ring = N * B, max(max(orders) - 1, 1)
    jstate = {
        "ring_lo": jnp.zeros((nb, ring), jnp.uint32), "ring_hi": jnp.zeros((nb, ring), jnp.uint32),
        "n_words": jnp.zeros(nb, jnp.int32), "fused": jnp.asarray(state["fused"]),
        "p_len": jnp.asarray(state["p_len"].astype(np.int32)),
    }
    for key in ("text_lo", "text_hi", "p_lo", "p_hi"):
        jstate[key] = jnp.asarray(state[key].astype(np.uint32))
    if hot:
        jstate["h_bits"] = jnp.asarray(state["h_bits"].astype(np.int32))
    for i in range(len(jdlms)):
        jstate[f"ctx{i}"] = jnp.asarray(state[f"ctx{i}"].astype(np.int32))
        jstate[f"ctx_len{i}"] = jnp.asarray(state[f"ctx_len{i}"].astype(np.int32))
        jstate[f"ctx_bo{i}"] = jnp.asarray(state[f"ctx_bo{i}"])
        jstate[f"p_flags{i}"] = jnp.asarray(state[f"p_flags{i}"].astype(np.int32))
    prm = jengine._params_dict(cfg, jnp.asarray(vec))
    return jengine._commit_quantities(jnp, cfg, devs, {}, prm, jstate, [jnp.asarray(r) for r in rows])


def assert_same_commit(got, want, n_lms, stats):
    """Every output of the torch commit equal to the JAX engine's, to the bit."""
    keys = ["text_lo", "text_hi", "word_fused"]
    keys += [f"{name}{i}" for i in range(n_lms) for name in ("ctx", "ctx_len", "ctx_bo")]
    for key in keys:
        g = got[key].numpy()
        w = np.asarray(want[key]).astype(g.dtype).reshape(g.shape)
        np.testing.assert_array_equal(g, w, err_msg=key)
    if stats:
        assert len(got["probe_hits"]) == n_lms
        for g_member, w_member in zip(got["probe_hits"], want["probe_hits"]):
            assert len(g_member) == len(w_member)
            for g, w in zip(g_member, w_member):
                np.testing.assert_array_equal(g.numpy().reshape(-1), np.asarray(w))


def case(models, orders, seed, hot=False, kenlm=False):
    rng = np.random.RandomState(seed)
    tdlms, jdlms, members = [], [], []
    for order in orders:
        tdlm, jdlm, tables_py = models[order]
        members.append(member_planes(tdlm, tables_py, rng, N * B))
        tdlms.append(kenlm_tables(tdlm, tables_py) if kenlm else tdlm)
        jdlms.append(jdlm)
    return tdlms, jdlms, beam_state(rng, members, hot), [m["row"] for m in members]


@pytest.mark.parametrize("order", [2, 3, 4])
@pytest.mark.parametrize("has_unigrams", [True, False])
def test_one_member_matches_lm_score_words_jnp_and_the_jax_commit(models, order, has_unigrams):
    tdlms, jdlms, state, rows = case(models, (order,), seed=order)
    assert set(state["ctx_len0"]) == set(range(order))  # every context length, empty to full
    tdlms[0] = dataclasses.replace(tdlms[0], has_unigrams=has_unigrams)
    vec = params(1, order)
    before = tc.commit_words.launches
    got = torch_commit(tdlms, state, rows, vec, hot=False, stats=False)
    assert tc.commit_words.launches == before  # the CPU runs the twin: no launch
    assert_same_commit(got, jax_commit(jdlms, state, rows, vec, False, False, has_unigrams), 1, False)

    # the raw score and out-state against the JAX scorer (alpha 1, beta 0, no OOV offset)
    vec_raw = vec.copy()
    vec_raw[3:6] = (1.0, 0.0, 0.0)
    got = torch_commit(tdlms, state, rows, vec_raw, hot=False, stats=False)
    jdlm, row, flags = jdlms[0], rows[0], state["p_flags0"]
    in_model = (flags & tdt.DeviceLM.BIT_IN_VOCAB) != 0
    wid = np.where(in_model, row[:, -1], jdlm.unk_id)
    unk = jdlm.uni[jdlm.unk_id]
    f1 = np.where(in_model, row[:, -2] != 0, unk[2] > 0.5)
    p1 = np.where(f1, np.where(in_model, row[:, -4].view(np.float32), unk[0]), 0.0).astype(np.float32)
    b1 = np.where(f1, np.where(in_model, row[:, -3].view(np.float32), unk[1]), 0.0).astype(np.float32)
    raw, ctx, ctx_len, bo = jdt.lm_score_words_jnp(
        jax_dev(jdlm), order, np.float32(jdlm.unk_prob10), jnp.asarray(state["ctx0"].astype(np.int32)),
        jnp.asarray(state["ctx_len0"].astype(np.int32)), jnp.asarray(wid.astype(np.int32)),
        jnp.asarray(state["ctx_bo0"]), uni_probe=(jnp.asarray(f1), jnp.asarray(p1), jnp.asarray(b1)),
    )
    commit = state["p_len"] > 0
    want_fused = np.where(commit, np.asarray(raw) * np.float32(LOG_BASE_CHANGE_FACTOR), 0.0).astype(np.float32)
    np.testing.assert_array_equal(got["word_fused"].numpy().reshape(-1), want_fused)
    np.testing.assert_array_equal(got["ctx0"].numpy().reshape(-1, order - 1)[commit], np.asarray(ctx)[commit])
    np.testing.assert_array_equal(got["ctx_len0"].numpy().reshape(-1)[commit], np.asarray(ctx_len)[commit])
    np.testing.assert_array_equal(got["ctx_bo0"].numpy().reshape(-1, order - 1)[commit], np.asarray(bo)[commit])
    assert (np.asarray(ctx_len)[commit] == order - 1).any()  # some words leave a full context


@pytest.mark.parametrize("has_unigrams", [True, False])
def test_oov_words_take_the_unk_score_and_the_offset(models, has_unigrams):
    """Beams in thirds: a node that is no vocabulary word (the word is <unk>), a vocabulary word outside
    the unigram list (OOV only where the model has a unigram list), a word in it."""
    tdlms, jdlms, state, rows = case(models, (3,), seed=11)
    tdlms[0] = dataclasses.replace(tdlms[0], has_unigrams=has_unigrams)
    in_vocab, uni_word = tdt.DeviceLM.BIT_IN_VOCAB, tdt.DeviceLM.BIT_UNI_WORD
    third = np.arange(N * B) % 3
    flags = state["p_flags0"] & ~(in_vocab | uni_word)
    state["p_flags0"] = flags | np.where(third > 0, in_vocab, 0) | np.where(third == 2, uni_word, 0)
    vec = params(1, 11)
    got = torch_commit(tdlms, state, rows, vec, hot=False, stats=False)
    assert_same_commit(got, jax_commit(jdlms, state, rows, vec, False, False, has_unigrams), 1, False)

    known = torch_commit(tdlms, dict(state, p_flags0=flags | in_vocab | uni_word), rows, vec, hot=False, stats=False)
    diff = (got["word_fused"] - known["word_fused"]).numpy().reshape(-1)
    commit = state["p_len"] > 0
    outside = commit & (third == 1)
    assert outside.sum() >= 3
    if has_unigrams:  # the offset, scaled as the score is
        np.testing.assert_allclose(diff[outside], vec[3] * vec[5] * LOG_BASE_CHANGE_FACTOR, rtol=1e-4)
    else:
        assert (diff[outside] == 0).all()
    assert (diff[third == 2] == 0).all()


def test_two_members_of_different_orders(models):
    tdlms, jdlms, state, rows = case(models, (3, 2), seed=21)
    vec = params(2, 21)
    got = torch_commit(tdlms, state, rows, vec, hot=False, stats=False)
    assert_same_commit(got, jax_commit(jdlms, state, rows, vec, False, False), 2, False)


def test_hotwords_add_their_weight_on_a_commit_only(models):
    tdlms, jdlms, state, rows = case(models, (3,), seed=31, hot=True)
    vec = params(1, 31)
    got = torch_commit(tdlms, state, rows, vec, hot=True, stats=False)
    assert_same_commit(got, jax_commit(jdlms, state, rows, vec, True, False), 1, False)
    plain = torch_commit(tdlms, state, rows, vec, hot=False, stats=False)
    gain = (got["word_fused"] - plain["word_fused"]).numpy().reshape(-1)
    hot_commit = ((state["h_bits"] & tdt.HOT_WORD_BIT) != 0) & (state["p_len"] > 0)
    assert hot_commit.any() and (~hot_commit).any()
    np.testing.assert_allclose(gain[hot_commit], HOT_WEIGHT, rtol=1e-5)
    assert (gain[~hot_commit] == 0).all()


@pytest.mark.parametrize("orders", [(3,), (4, 2)])
def test_kenlm_hash_tables_score_as_the_fnv_tables(models, orders):
    """Tables keyed by KenLM's chain (``kenlm64``) answer every probe as the id-keyed ones do."""
    tdlms, jdlms, state, rows = case(models, orders, seed=41 + len(orders), kenlm=True)
    vec = params(len(orders), 41)
    got = torch_commit(tdlms, state, rows, vec, hot=False, stats=True)
    assert_same_commit(got, jax_commit(jdlms, state, rows, vec, False, True), len(orders), True)


@pytest.mark.parametrize("orders", [(2,), (4,), (3, 2)])
def test_collect_stats_hit_masks(models, orders):
    tdlms, jdlms, state, rows = case(models, orders, seed=51 + sum(orders), hot=True)
    vec = params(len(orders), 51)
    got = torch_commit(tdlms, state, rows, vec, hot=True, stats=True)
    assert_same_commit(got, jax_commit(jdlms, state, rows, vec, True, True), len(orders), True)
    assert got["probe_hits"][0][-1].any()  # the model's longest n-grams are hit
    idle = state["p_len"] == 0  # the probes count on beams with no partial word too
    assert any(hits.numpy().reshape(-1)[idle].any() for hits in got["probe_hits"][0][1:])


def test_beams_without_a_partial_word_pass_through(models):
    tdlms, _, state, rows = case(models, (4, 3), seed=61, hot=True)
    got = torch_commit(tdlms, state, rows, params(2, 61), hot=True, stats=False)
    idle = state["p_len"] == 0
    assert idle.sum() >= 3
    for key in ["text_lo", "text_hi"] + [f"{n}{i}" for i in range(2) for n in ("ctx", "ctx_len", "ctx_bo")]:
        g = got[key].numpy()
        np.testing.assert_array_equal(g.reshape((N * B,) + g.shape[2:])[idle], state[key][idle], err_msg=key)
    assert (got["word_fused"].numpy().reshape(-1)[idle] == 0).all()


def test_device_parameters_give_the_host_parameters_results(models):
    """The segment programs pass the parameters as 0-d f32 tensors (a graph reads them at each replay)."""
    tdlms, _, state, rows = case(models, (3, 2), seed=71, hot=True)
    vec = params(2, 71)
    host = torch_commit(tdlms, state, rows, vec, hot=True, stats=False)
    dev = torch_commit(tdlms, state, rows, vec, hot=True, stats=False, on_device_params=True)
    for key in host:
        assert torch.equal(host[key], dev[key]), key


def _dev(order, shard=False, tables=None):
    lm = {"order": order, "fp": [{}] * (order - 1 if tables is None else tables)}
    if shard:
        lm["shard"] = object()
    return lm


def test_the_kernel_takes_whole_tables_of_orders_two_and_up_eight_tables_at_most():
    assert tc.commit_kernel_fits([])
    assert tc.commit_kernel_fits([_dev(3)])
    assert tc.commit_kernel_fits([_dev(3), _dev(2)])
    assert tc.commit_kernel_fits([_dev(5), _dev(5)])  # 8 tables
    assert tc.commit_kernel_fits([_dev(9)])
    assert not tc.commit_kernel_fits([_dev(3, shard=True)])  # a collective probe
    assert not tc.commit_kernel_fits([_dev(3), _dev(2, shard=True)])
    assert not tc.commit_kernel_fits([_dev(1, tables=0)])  # no table to probe
    assert not tc.commit_kernel_fits([_dev(3), _dev(1, tables=0)])
    assert not tc.commit_kernel_fits([_dev(5), _dev(6)])  # 9 tables
    assert not tc.commit_kernel_fits([_dev(10)])
    assert not tc.commit_kernel_fits([_dev(2)] * 9)


@pytest.mark.parametrize("members,kernel", [
    ([_dev(3)], True), ([_dev(4), _dev(2)], True), ([], True),
    ([_dev(3, shard=True)], False), ([_dev(1, tables=0)], False), ([_dev(5), _dev(6)], False),
])
def test_the_engine_chooses_from_the_tables(monkeypatch, members, kernel):
    calls = []
    monkeypatch.setattr(tengine, "commit_words", lambda *a: calls.append("kernel") or {})
    monkeypatch.setattr(tengine, "commit_words_ref", lambda *a: calls.append("composition") or {})
    cfg = tengine.EngineConfig(beam_width=4, vocab_size=8, k_tokens=8, prune_history=False,
                               orders=tuple(m["order"] for m in members))
    tengine._commit_quantities(cfg, members, {"lm": [{}] * len(members)}, {}, [None] * len(members))
    assert calls == ["kernel" if kernel else "composition"]


def test_a_decode_commits_through_the_wrapper(models, tmp_path):
    """The engine's step calls the wrapper (the twin on the CPU) once a step, and a decode equals the
    composition's step for step."""
    import pyctcdecode_torch as P
    from pyctcdecode_torch.models.ngram import open_ngram_file as open_lm

    path = tmp_path / "lm.arpa"
    path.write_text(ARPA)
    dec = P.TorchBeamSearchDecoderCTC(
        P.Alphabet.build_alphabet(SAMPLE_LABELS), P.LanguageModel(open_lm(str(path)), UNIGRAMS), device="cpu")
    rng = np.random.RandomState(3)
    logits = np.log(rng.dirichlet(np.ones(len(SAMPLE_LABELS)) * 0.3, size=30)).astype(np.float32)
    calls = []
    real = tengine.commit_words

    def counted(*args):
        calls.append(1)
        return real(*args)

    tengine.commit_words = counted
    try:
        got = dec.decode_beams(logits, beam_width=8)
    finally:
        tengine.commit_words = real
    assert len(calls) == len(logits)
    tengine_kernel = tengine.commit_words
    tengine.commit_words = tengine.commit_words_ref
    try:
        want = dec.decode_beams(logits, beam_width=8)
    finally:
        tengine.commit_words = tengine_kernel
    assert [(b.text, b.logit_score, b.lm_score) for b in got] == [(b.text, b.logit_score, b.lm_score) for b in want]


def test_the_wrapper_refuses_what_the_kernel_does_not_take(models):
    tdlms, _, state, rows = case(models, (3,), seed=81)
    vec = params(1, 81)
    cfg = tengine.EngineConfig(beam_width=B, vocab_size=8, k_tokens=8, prune_history=False, orders=(3,))
    prm = tengine._params_dict(cfg, vec)
    lms = [d.as_device("cpu") for d in tdlms]
    tstate = {k: torch.as_tensor(v).reshape((N, B) + v.shape[1:]) for k, v in state.items()}
    trows = [torch.as_tensor(r).reshape(N, B, ROW_W) for r in rows]
    with pytest.raises(TypeError, match="ctx_len0"):
        tc.commit_words(lms, prm, dict(tstate, ctx_len0=tstate["ctx_len0"].to(torch.int32)), trows, False, False)
    with pytest.raises(ValueError, match="ctx_bo0"):
        tc.commit_words(lms, prm, dict(tstate, ctx_bo0=tstate["ctx_bo0"][..., :1].contiguous()), trows, False, False)
    with pytest.raises(ValueError, match="trie row planes"):
        tc.commit_words(lms, prm, tstate, [], False, False)
    with pytest.raises(KeyError, match="h_bits"):
        tc.commit_words(lms, prm, tstate, trows, True, False)
    meta = torch.device("meta")  # neither the CPU nor CUDA: refuse, do not fall back
    with pytest.raises(ValueError, match="CUDA tensors"):
        tc.commit_words(lms, prm, {k: v.to(meta) for k, v in tstate.items()}, [r.to(meta) for r in trows],
                        False, False)
