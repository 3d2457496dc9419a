"""``walk_partial``: the engine step's trie walk and partial score, held on the CPU.

On CPU tensors the wrapper runs its plain twin (``walk_partial_ref``, the
PyTorch composition the step ran before the kernel), and the CUDA kernel is
held to that twin on the card (``test_torch_kernels_cuda.py``, on the same
cases). Here the twin is held to the JAX engine's walk: the JAX package's
own ``_decode_trie_cells`` and ``_partial_score`` over the same tables,
driven level by level as its ``_make_step`` drives them (the one-letter
branch from the beams' fetched rows, the multi-letter branch from the trie
plane), one utterance at a time as its step runs under ``vmap``. The cases
(``tests/walk_cases.py``): one-letter labels, wav2vec2's 32 labels (4
levels), 129 BPE pieces (5 levels), two members with hotwords on timeline
chunks, and beams in the corners (the dead node, forced after a
right-bounded piece, repeats, long partials). The last tests pin the
engine's choice between the kernel and the composition.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyctcdecode_torch import engine as tengine
from pyctcdecode_torch.models.device_tables import HOT_NODE_MASK, DeviceLM
from pyctcdecode_torch.ops import walk as tw
from pyctcdecode_tpu import engine as jengine

from .helpers import SAMPLE_LABELS
from .torch_cases import word_logits
from .torch_cases import one_torch_thread  # noqa: F401  (autouse fixture)
from .walk_cases import CASES, HOT_WEIGHT, classes, walk_decoder, walk_inputs

_NODE_MASK = DeviceLM.NODE_MASK


@pytest.fixture(scope="module")
def decoders(tmp_path_factory):
    root = tmp_path_factory.mktemp("walk")
    return {case: walk_decoder(case, root, "cpu") for case in CASES}


def _pick_cols(rows, idx):
    """``rows[:, idx]`` as the JAX engine's one-letter branch takes it (a one-hot masked sum)."""
    cmask = idx[:, None] == jnp.arange(rows.shape[1], dtype=idx.dtype)[None, :]
    return jnp.sum(jnp.where(cmask[None, :, :], rows[:, None, :], 0), axis=2, dtype=rows.dtype)


def jax_walk(args):
    """The JAX engine's walk and partial score of each utterance: ``(ent [N, B, K] per member, h_ent, pscore
    [N, B, K])``, from the JAX package's functions over the same tables (``engine.py:946`` onward)."""
    lms, hot, prm, state, toks, tok, trie_rows, is_bpe = args
    np_state = {key: val.numpy() for key, val in state.items()}
    n_lms, use_hot = len(lms), hot is not None
    kind, raw_chars = tok["kind"].numpy(), tok["raw_chars"].numpy()
    lmax = raw_chars.shape[1]
    cfg = types.SimpleNamespace(n_lms=n_lms, use_hotwords=use_hot)
    jprm = {"lm": [{"unk_offset": jnp.float32(prm["lm"][i]["unk_offset"])} for i in range(n_lms)],
            "hot_weight": jnp.float32(prm["hot_weight"])}
    jhot = {"dead": hot["dead"]} if use_hot else None
    planes = [jnp.asarray(lm["trie_rows"].numpy()) for lm in lms]
    hot_next = jnp.asarray(hot["next"].numpy().astype(np.int32)) if use_hot else None
    out_ent, out_h, out_score = [[] for _ in lms], [], []
    for n in range(toks.shape[0]):
        toks_n = toks[n].numpy()
        b, k = np_state["p_len"].shape[1], toks_n.shape[0]
        blank, boundary_kind = jnp.asarray(kind[toks_n] == 0), jnp.asarray(kind[toks_n] == 1)
        last = jnp.asarray(np_state["last_tok"][n].astype(np.int32))
        stay = blank[None, :] | (last[:, None] == jnp.asarray(toks_n.astype(np.int32))[None, :])
        if is_bpe:
            as_boundary = ~stay & (boundary_kind[None, :] | jnp.asarray(np_state["force"][n])[:, None])
        else:
            as_boundary = ~stay & boundary_kind[None, :]
        cur = [jnp.asarray((np_state[f"p_node{i}"][n] | np_state[f"p_flags{i}"][n]).astype(np.int32))
               for i in range(n_lms)]
        ext_entries = [jnp.broadcast_to(c[:, None], (b, k)) for c in cur]
        if use_hot:
            h_node = jnp.asarray(np_state["h_node"][n].astype(np.int32))
            h_cur = jnp.asarray((np_state["h_node"][n] | np_state["h_bits"][n]).astype(np.int32))
            ext_hentry = jnp.broadcast_to(h_cur[:, None], (b, k))
        if lmax == 1:
            cid = jnp.asarray(raw_chars[toks_n, 0].astype(np.int32))
            has = (cid >= 0)[None, :]
            cid_safe = jnp.maximum(cid, 0)
            cid_b = jnp.broadcast_to(cid_safe[None, :], (b, k))
            for i, lm in enumerate(lms):
                tp = lm["trie_pack"]
                rows = jnp.asarray(trie_rows[i][n].numpy())
                word = _pick_cols(rows[:, 1 : 1 + tp["ncw"]], cid_safe // tp["cpw"])
                ent = jengine._decode_trie_cells(jnp, jax, tp, rows[:, 0:1], word, cid_b)
                ext_entries[i] = jnp.where(has, ent, ext_entries[i])
            if use_hot:
                ext_hentry = jnp.where(has, _pick_cols(hot_next[h_node], cid_safe), ext_hentry)
        else:
            for l in range(lmax):
                cid = jnp.asarray(raw_chars[toks_n, l].astype(np.int32))
                has = (cid >= 0)[None, :]
                cid_b = jnp.broadcast_to(jnp.maximum(cid, 0)[None, :], (b, k))
                for i, lm in enumerate(lms):
                    tp = lm["trie_pack"]
                    node = ext_entries[i] & _NODE_MASK
                    slot = (node % tp["pack"]) * tp["stride"]
                    word = planes[i][node // tp["pack"], slot + 1 + cid_b // tp["cpw"]]
                    fc = planes[i][node // tp["pack"], slot]
                    ent = jengine._decode_trie_cells(jnp, jax, tp, fc, word, cid_b)
                    ext_entries[i] = jnp.where(has, ent, ext_entries[i])
                if use_hot:
                    ext_hentry = jnp.where(has, hot_next[ext_hentry & HOT_NODE_MASK, cid_b], ext_hentry)
        p_len = jnp.asarray(np_state["p_len"][n].astype(np.int32))
        p_len_n = jnp.where(stay, p_len[:, None], jnp.where(
            as_boundary, jnp.asarray(tok["piece_len"].numpy()[toks_n].astype(np.int32))[None, :],
            p_len[:, None] + jnp.asarray(tok["raw_len"].numpy()[toks_n].astype(np.int32))[None, :]))
        p_entry_n = []
        for i, lm in enumerate(lms):
            seed = jnp.asarray(lm["seed_node"].numpy()[toks_n].astype(np.int32))
            p_entry_n.append(jnp.where(stay, cur[i][:, None], jnp.where(as_boundary, seed[None, :], ext_entries[i])))
        h_entry_n = None
        if use_hot:
            seed = jnp.asarray(hot["seed"].numpy()[toks_n].astype(np.int32))
            h_entry_n = jnp.where(stay, h_cur[:, None], jnp.where(as_boundary, seed[None, :], ext_hentry))
            out_h.append(np.asarray(h_entry_n))
        score = jengine._partial_score(
            jnp, cfg, jhot, jprm, [e & ~_NODE_MASK for e in p_entry_n],
            h_entry_n & HOT_NODE_MASK if use_hot else None, h_entry_n & ~HOT_NODE_MASK if use_hot else None,
            p_len_n)
        for i, e in enumerate(p_entry_n):
            out_ent[i].append(np.asarray(e))
        out_score.append(np.asarray(score))
    return ([np.stack(e) for e in out_ent], np.stack(out_h) if use_hot else None, np.stack(out_score))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("seed", [1, 2])
def test_the_plain_walk_equals_the_jax_engines(decoders, case, seed):
    args = walk_inputs(case, decoders[case], seed)
    got_ent, got_h, got_score = tw.walk_partial(*args)  # the twin, on these CPU tensors
    want_ent, want_h, want_score = jax_walk(args)
    n, b = args[3]["p_len"].shape
    k = args[4].shape[1]
    assert len(got_ent) == len(want_ent) == len(args[0])
    for g, w in zip(got_ent, want_ent):
        assert g.dtype == torch.int64 and tuple(g.shape) == (n, b, k)
        np.testing.assert_array_equal(g.numpy(), w.astype(np.int64))
    if args[1] is None:
        assert got_h is None
    else:
        np.testing.assert_array_equal(got_h.numpy(), want_h.astype(np.int64))
    assert got_score.dtype == torch.float32 and tuple(got_score.shape) == (n, k, b)
    np.testing.assert_array_equal(got_score.transpose(1, 2).numpy(), want_score)
    seen = classes(args)
    assert seen["stay"] > 0 and seen["walks"] > 0
    if case != "two members, hotwords":  # the timeline's few columns may hold no boundary token
        assert seen["boundary"] > 0
    if args[7]:
        assert seen["forced"] > 0
    if case == "edges":
        assert seen["dead"] > 0 and (args[3]["p_len"] > 6).any()


@pytest.mark.parametrize("case,lmax,levels", [("char", 1, 1), ("w2v2", 4, 4), ("bpe", 5, 5)])
def test_the_cases_walk_the_levels_they_name(decoders, case, lmax, levels):
    """The longest label sets the levels: w2v2's ``</s>`` four, BPE's ``▁`` + 4 letters five."""
    tok = decoders[case]._tabs["tok"]
    assert tok["raw_chars"].shape[1] == lmax
    assert int(tok["raw_len"].max()) == levels


def test_parameters_on_the_device_give_the_host_numbers(decoders):
    """The segment programs' 0-d parameter views give what the host vector gives, to the bit."""
    for case in ("two members, hotwords", "edges"):
        host = tw.walk_partial(*walk_inputs(case, decoders[case], 5))
        dev = tw.walk_partial(*walk_inputs(case, decoders[case], 5, params_on_device=True))
        for g, w in zip(host[0], dev[0]):
            assert torch.equal(g, w)
        assert torch.equal(host[1], dev[1])
        assert torch.equal(host[2].view(torch.int32), dev[2].view(torch.int32))


def test_no_lm_and_no_hotwords_score_zero(decoders):
    lms, _, prm, state, toks, tok, _, is_bpe = walk_inputs("char", decoders["char"], 3)
    ent, h_ent, pscore = tw.walk_partial([], None, prm, state, toks, tok, [], is_bpe)
    assert ent == [] and h_ent is None
    assert tuple(pscore.shape) == (toks.shape[0], toks.shape[1], state["p_len"].shape[1])
    assert torch.equal(pscore, torch.zeros_like(pscore))


def test_the_kernel_takes_up_to_eight_members_with_or_without_hotwords():
    assert tw.walk_kernel_fits([])
    assert tw.walk_kernel_fits([{}])
    assert tw.walk_kernel_fits([{"shard": object()}])  # the trie planes are whole on every process
    assert tw.walk_kernel_fits([{}] * tw.MAX_MEMBERS)
    assert not tw.walk_kernel_fits([{}] * (tw.MAX_MEMBERS + 1))


@pytest.mark.parametrize("members,use_hot,kernel", [
    (1, False, True), (2, True, True), (0, True, True), (0, False, True), (8, True, True), (9, False, False),
])
def test_the_engine_chooses_from_the_members(monkeypatch, members, use_hot, kernel):
    calls = []
    monkeypatch.setattr(tengine, "walk_partial", lambda *a: calls.append(("kernel", a[1])))
    monkeypatch.setattr(tengine, "walk_partial_ref", lambda *a: calls.append(("composition", a[1])))
    cfg = tengine.EngineConfig(beam_width=4, vocab_size=8, k_tokens=8, prune_history=False,
                               use_hotwords=use_hot, orders=(3,) * members)
    hot = {"dead": 0}
    tengine._walk_quantities(cfg, [{}] * members, hot, {}, {}, None, {}, [None] * members)
    assert calls == [("kernel" if kernel else "composition", hot if use_hot else None)]


def test_a_decode_walks_through_the_wrapper(decoders):
    """The engine's step calls the wrapper (the twin on the CPU) once a step, and a decode equals the
    composition's step for step."""
    dec = decoders["two members, hotwords"]
    logits = word_logits(7, 30)
    assert logits.shape[1] == len(SAMPLE_LABELS)
    kw = dict(beam_width=8, hotwords=["bugs bunny", "sun"], hotword_weight=HOT_WEIGHT)
    calls = []
    real = tengine.walk_partial

    def counted(*args):
        calls.append(1)
        return real(*args)

    tengine.walk_partial = counted
    try:
        got = dec.decode_beams(logits, **kw)
    finally:
        tengine.walk_partial = real
    assert len(calls) == len(logits)
    tengine.walk_partial = tengine.walk_partial_ref
    try:
        want = dec.decode_beams(logits, **kw)
    finally:
        tengine.walk_partial = real
    assert [(b.text, b.logit_score, b.lm_score) for b in got] == [(b.text, b.logit_score, b.lm_score) for b in want]


def test_the_wrapper_refuses_what_the_kernel_does_not_take(decoders):
    lms, hot, prm, state, toks, tok, rows, is_bpe = walk_inputs("char", decoders["char"], 4)
    with pytest.raises(TypeError, match="last_tok"):
        tw.walk_partial(lms, hot, prm, dict(state, last_tok=state["last_tok"].to(torch.int32)), toks, tok, rows,
                        is_bpe)
    with pytest.raises(ValueError, match="toks"):
        tw.walk_partial(lms, hot, prm, state, toks[:2].contiguous(), tok, rows, is_bpe)
    with pytest.raises(ValueError, match="trie row planes"):
        tw.walk_partial(lms, hot, prm, state, toks, tok, [], is_bpe)
    with pytest.raises(KeyError, match="h_node"):
        tw.walk_partial(lms, {"next": tok["kind"], "seed": tok["kind"], "dead": 0}, prm, state, toks, tok, rows,
                        is_bpe)
    meta = torch.device("meta")  # neither the CPU nor CUDA: refuse, do not fall back
    with pytest.raises(ValueError, match="CUDA tensors"):
        tw.walk_partial([{**lm, "trie_rows": lm["trie_rows"].to(meta), "seed_node": lm["seed_node"].to(meta)}
                         for lm in lms], hot, prm, {key: val.to(meta) for key, val in state.items()},
                        toks.to(meta), {key: val.to(meta) for key, val in tok.items()},
                        [r.to(meta) for r in rows], is_bpe)
