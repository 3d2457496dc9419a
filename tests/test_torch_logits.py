"""Host prep of the serving path: the port's numpy functions vs the JAX package's.

``blank_collapse``, ``token_timeline``, ``normalize_collapse_batch`` and
``token_timeline_batch`` are numpy on both sides and the port's are copies,
so every output must be bit-equal, on seeded ragged batches that include an
empty and a one-frame utterance, probabilities as well as logits, and a batch
large enough to be split over the host thread pool.
"""
import numpy as np
import pytest

from pyctcdecode_torch.utils import logits as tl
from pyctcdecode_tpu.utils import logits as jl

from .torch_cases import one_torch_thread  # noqa: F401  (autouse fixture)

V = 9
BLANK = V - 1


def ragged_batch(seed, lens, probs_every=0):
    """Peaked random logits with blank-certain runs; every ``probs_every``-th as probabilities."""
    rng = np.random.RandomState(seed)
    mats = []
    for i, t in enumerate(lens):
        mat = (rng.randn(t, V) * 1.5).astype(np.float32)
        if t:
            mat[np.arange(t), rng.randint(0, V, size=t)] += 4.0
            lo = rng.randint(0, t)
            mat[lo : lo + 6, BLANK] += 15.0
        if probs_every and i % probs_every == 0 and t:
            e = np.exp(mat - mat.max(axis=1, keepdims=True))
            mat = (e / e.sum(axis=1, keepdims=True)).astype(np.float32)
        mats.append(mat)
    return mats


def assert_tuples_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


LENS = [23, 0, 1, 40, 7, 1, 31]


@pytest.mark.parametrize("t", [0, 1, 2, 37])
@pytest.mark.parametrize("token_min_logp", [-5.0, -2.0])
def test_blank_collapse_and_token_timeline_bit_equal(t, token_min_logp):
    logp = tl.normalize_to_logp(ragged_batch(t, [t])[0]).astype(np.float32)
    np.testing.assert_array_equal(logp, jl.normalize_to_logp(ragged_batch(t, [t])[0]).astype(np.float32))
    g_keep, g_off = tl.blank_collapse(logp, BLANK, token_min_logp)
    w_keep, w_off = jl.blank_collapse(logp, BLANK, token_min_logp)
    np.testing.assert_array_equal(g_keep, w_keep)
    assert g_off == w_off
    if t == 37:
        assert len(g_keep) < t and g_off < 0.0  # the blank run collapsed
    for k_chunk in (1, 3, 5, V + 2):
        assert_tuples_equal(
            tl.token_timeline(logp, token_min_logp, k_chunk),
            jl.token_timeline(logp, token_min_logp, k_chunk),
        )


@pytest.mark.parametrize(
    "lens,probs_every",
    [(LENS, 0), (LENS, 2), ([0, 0], 0), ([5] * 70 + [0, 1] + [9] * 70, 3)],
)
def test_normalize_collapse_batch_bit_equal(lens, probs_every):
    mats = ragged_batch(len(lens), lens, probs_every)
    got = tl.normalize_collapse_batch(mats, BLANK, -5.0)
    want = jl.normalize_collapse_batch(mats, BLANK, -5.0)
    for g_list, w_list in zip(got[:2], want[:2]):
        assert_tuples_equal(g_list, w_list)
    assert got[2] == want[2]
    assert_tuples_equal(tl.normalize_batch(mats), jl.normalize_batch(mats))
    # and equal to the per-utterance functions
    for mat, col, keep, off in zip(mats, *got):
        logp = tl.normalize_to_logp(mat).astype(np.float32)
        k2, o2 = tl.blank_collapse(logp, BLANK, -5.0)
        np.testing.assert_array_equal(keep, k2)
        np.testing.assert_array_equal(col, logp[k2])
        assert off == o2


@pytest.mark.parametrize("lens", [LENS, [0, 0], [4] * 80 + [0, 1] + [6] * 60])
@pytest.mark.parametrize("k_chunk", [2, 5])
def test_token_timeline_batch_bit_equal(lens, k_chunk):
    mats = tl.normalize_batch(ragged_batch(len(lens) + k_chunk, lens))
    g_tls, g_vlens = tl.token_timeline_batch(mats, -4.0, k_chunk)
    w_tls, w_vlens = jl.token_timeline_batch(mats, -4.0, k_chunk)
    np.testing.assert_array_equal(g_vlens, w_vlens)
    assert len(g_tls) == len(lens)
    for mat, g, w, vlen in zip(mats, g_tls, w_tls, g_vlens):
        assert_tuples_equal(g, w)
        assert g[0].shape == (vlen, k_chunk)
        # and equal in value to the per-utterance function (whose frame ids are int64)
        for g_part, one_part in zip(g, tl.token_timeline(mat, -4.0, k_chunk)):
            np.testing.assert_array_equal(g_part, one_part)


def test_float64_probabilities_take_the_per_utterance_path():
    mats = [m.astype(np.float64) for m in ragged_batch(5, [12, 3], probs_every=1)]
    assert_tuples_equal(tl.normalize_batch(mats), jl.normalize_batch(mats))
    assert_tuples_equal(
        tl.normalize_collapse_batch(mats, BLANK, -5.0)[0],
        jl.normalize_collapse_batch(mats, BLANK, -5.0)[0],
    )
