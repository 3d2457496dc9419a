"""The batch decode's backtrace and the finalize in its keyed form, held against the JAX package.

``backtrace_paths_ref`` (the plain version of the CUDA kernel
``backtrace_paths``, which the CPU path runs) against the ``paths`` of the
JAX package's compiled finalize (``fin_fn`` of its
``make_segment_decode_fns``, with ``emit_paths`` set: a ``lax.scan``
backward over the packed log), on seeded logs, bit-exact: every parent and
path dtype the engines pick (beam 100 and 200, V 29 and 129), padded frames
(-1, identity parents), timeline carry markers (-3), and 1, 10 or all B
ranks.

The finalize a CUDA graph captures (``engine.finalize_program``: the
``score_boundary`` flags and, for a stream, ``(do_commit, is_end)`` fixed
by its key, the parameters read as a tensor) runs eagerly here and equals
the JAX package's stream ``finalize_fn`` (the two flags traced) on a real
mid-stream state, in the three streaming modes, with ``score_boundary`` on
and off: ranks, scores within 1e-4 (both engines score in float32), and
the committed carried state.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyctcdecode_torch as P
from pyctcdecode_torch.engine import _parent_dtype, _path_dtype, finalize_program, score_boundary_flags
from pyctcdecode_torch.models.ngram import open_ngram_file
from pyctcdecode_torch.ops.backtrace import backtrace_paths, backtrace_paths_ref
from pyctcdecode_tpu import Alphabet as JAlphabet
from pyctcdecode_tpu import LanguageModel as JLanguageModel
from pyctcdecode_tpu import TPUBeamSearchDecoderCTC
from pyctcdecode_tpu.engine import make_segment_decode_fns as jmake_segment_decode_fns
from pyctcdecode_tpu.models.ngram import NGramModel as JNGramModel

from .helpers import SAMPLE_LABELS
from .torch_cases import (
    ARPA,
    LM_WORDS,
    UNIGRAMS,
    assert_same_stream_state,
    conformer_width,
    piece_vocabulary,
    word_logits,
)
from .torch_cases import one_torch_thread  # noqa: F401  (autouse fixture)

CHAR_LABELS = [" "] + list("abcdefghijklmnopqrstuvwxyz") + ["'", ""]  # V = 29
WIDE = conformer_width(piece_vocabulary(LM_WORDS))  # V = 129
T = 24
DEAD_THRESH = -1.0e29


def _logs(rng, b, t, n_frames):
    """Seeded logs ``[T, B]``: random parents and tokens, carry markers, padded frames past ``n_frames``."""
    parents = rng.randint(0, b, (t, b))
    trace = rng.randint(-1, 29, (t, b))
    carry = rng.rand(t) < 0.25  # a frame's non-final timeline chunks
    trace[carry] = -3
    parents[carry] = np.arange(b)
    trace[n_frames:] = -1
    parents[n_frames:] = np.arange(b)
    return parents, trace


@pytest.fixture(scope="module")
def jax_decoders():
    cache = {}

    def get(v):
        if v not in cache:
            cache[v] = TPUBeamSearchDecoderCTC(JAlphabet.build_alphabet(CHAR_LABELS if v == 29 else WIDE), None)
        return cache[v]

    return get


@pytest.mark.parametrize("emit", [1, 10, None])
@pytest.mark.parametrize("b,v", [(100, 29), (200, 29), (100, 129), (200, 129)])
def test_backtrace_ref_equals_jax_fin_fn_paths(jax_decoders, b, v, emit):
    jdec = jax_decoders(v)
    assert len(jdec._labels) == v
    r = b if emit is None else emit
    cfg = jdec._engine_cfg(b, v, False, False, emit_paths=r)
    init_fn, _, fin_fn = jmake_segment_decode_fns(cfg, jdec._tokens, jdec._device_lm, 1)
    rng = np.random.RandomState(b + v + r)
    state = dict(init_fn(()))
    # distinct texts (no merges) and a spread of live and dead beams
    state["text_lo"] = jnp.asarray(rng.randint(0, 2**31, b).astype(np.uint32))
    state["text_hi"] = jnp.asarray(rng.randint(0, 2**31, b).astype(np.uint32))
    logit = rng.uniform(-8.0, 0.0, b).astype(np.float32)
    logit[rng.rand(b) < 0.2] = -1.0e30
    state["logit"] = jnp.asarray(logit)
    parents, trace = _logs(rng, b, T, n_frames=T - 5)
    packed = (parents | ((trace + 4) << 16)).astype(np.int32)
    params = jnp.asarray(jdec._params_vector(-5.0, -1000.0))
    out = jax.jit(fin_fn)(state, params, jdec._tabs, jnp.asarray(packed))
    want = np.asarray(out["paths"])
    src = np.asarray(out["beam_src"]).astype(np.int64)
    assert want.shape == (r, T)
    par_t = torch.as_tensor(parents).to(_parent_dtype(b))[None]
    tok_t = torch.as_tensor(trace).to(_path_dtype(v))[None]
    got = backtrace_paths_ref(par_t, tok_t, torch.as_tensor(src)[None])[0].numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert (got == -3).any() and (got[:, -5:] == -1).all()
    # the wrapper on CPU tensors is the plain version
    np.testing.assert_array_equal(backtrace_paths(par_t, tok_t, torch.as_tensor(src)[None])[0].numpy(), want)


@pytest.fixture(scope="module")
def stream_pairs(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("lm") / "bb3.arpa")
    with open(path, "w") as fh:
        fh.write(ARPA)
    cache = {}

    def get(score_boundary):
        if score_boundary not in cache:
            kw = dict(score_boundary=score_boundary)
            cache[score_boundary] = (
                TPUBeamSearchDecoderCTC(JAlphabet.build_alphabet(SAMPLE_LABELS),
                                        JLanguageModel(JNGramModel.from_file(path), UNIGRAMS, **kw)),
                P.TorchBeamSearchDecoderCTC(P.Alphabet.build_alphabet(SAMPLE_LABELS),
                                            P.LanguageModel(open_ngram_file(path), UNIGRAMS, **kw),
                                            device="cpu"),
            )
        return cache[score_boundary]

    return get


@pytest.mark.parametrize("score_boundary", [True, False])
@pytest.mark.parametrize("do_commit,is_end", [(False, False), (True, False), (True, True)])
def test_keyed_finalize_equals_jax_finalize_fn(stream_pairs, do_commit, is_end, score_boundary):
    jdec, pdec = stream_pairs(score_boundary)
    mat = word_logits(9, 23)  # a chunk that ends mid-word for some beams
    start = dict(beam_width=12, prune_history=True)
    js, ps = jdec.get_starting_state(**start), pdec.get_starting_state(**start)
    jdec.partial_decode_beams(js, mat)
    pdec.partial_decode_beams(ps, mat)
    assert int((ps.beam_state["p_len"] > 0).sum()) > 0  # partial words to commit
    params = pdec._params_vector(-5.0, -10.0)
    _, _, jfin = jdec._get_stream_fns(12, len(SAMPLE_LABELS), True, False)
    want = jfin(js.beam_state, jnp.asarray(params), np.float32(do_commit), np.float32(is_end), jdec._tabs, None)
    cfg = pdec._engine_cfg(12, len(SAMPLE_LABELS), True, False)
    flags = score_boundary_flags(cfg, params)
    assert flags == (score_boundary,)
    fn = finalize_program(cfg, pdec._tabs, flags, (do_commit, is_end))
    got = fn(ps.beam_state, torch.as_tensor(params))
    score, w_score = got["score"][0].numpy(), np.asarray(want["score"])
    live = w_score > DEAD_THRESH
    np.testing.assert_array_equal(score > DEAD_THRESH, live)
    np.testing.assert_array_equal(got["src"][0].numpy()[live], np.asarray(want["src"])[live])
    np.testing.assert_allclose(score[live], w_score[live], atol=1e-4, rtol=0)
    np.testing.assert_allclose(got["logit"][0].numpy()[live], np.asarray(want["logit"])[live], atol=1e-4, rtol=0)
    committed = {key[len("next."):]: val for key, val in got.items() if key.startswith("next.")}
    assert bool(committed) == do_commit
    if do_commit:
        assert_same_stream_state(want["committed_state"], committed)
    # the eager stream finalize on the host vector gives the same, to the bit
    _, _, finalize_fn = pdec._get_stream_fns(12, len(SAMPLE_LABELS), True, False)
    ranked, eager_committed = finalize_fn(ps.beam_state, params, do_commit, is_end)
    for key in ("src", "score", "logit"):
        assert torch.equal(ranked[key], got[key]), key
    if do_commit:
        for key, val in eager_committed.items():
            assert torch.equal(val, committed[key]), key
