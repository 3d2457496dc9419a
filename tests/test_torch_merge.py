"""Merge kernels: plain PyTorch versions vs the Pallas kernels (interpret mode).

``merge_prune_ref`` / ``expand_merge_prune_ref`` must compute what the JAX
package's ``merge_score_pallas`` / ``expand_merge_score_pallas`` compute,
single and under ``jax.vmap`` (the batched-grid rule), for char and BPE-like
shapes. Tolerance: ``atol 1e-5`` on scores (the group logsumexp sums its
exponentials in another order), ``src`` exact at live entries. The CUDA
kernels themselves are held against the same plain versions on the card
(``test_torch_kernels_cuda.py`` and ``chip_smoke.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyctcdecode_torch.ops import merge as tm
from pyctcdecode_tpu.ops import pallas_merge as pm

from .torch_cases import (
    DEAD,
    assert_outputs,
    chunk_token_planes,
    expand_inputs,
    merge_inputs,
    torch_merge_args,
    torch_planes,
)
from .torch_cases import one_torch_thread  # noqa: F401  (autouse fixture)


@pytest.mark.parametrize("n,k,b,seed", [(1, 6, 16, 3), (1, 1, 24, 4), (3, 5, 12, 5)])
def test_merge_prune_ref_matches_pallas(n, k, b, seed):
    kl, kh, valid, logit, extra, prune = merge_inputs(np.random.RandomState(seed), n, k, b)
    got = tm.merge_prune_ref(*torch_merge_args(kl, kh, valid, logit, extra, prune))
    if n == 1:
        want = pm.merge_score_pallas(
            jnp.asarray(kl[0]), jnp.asarray(kh[0]), jnp.asarray(valid[0].astype(np.int32)),
            jnp.asarray(logit[0]), jnp.asarray(extra[0]), jnp.float32(prune[0]),
            interpret=True,
        )
        want = tuple(np.asarray(x)[None] for x in want)
    else:
        want = jax.vmap(
            lambda a, bb, c, d, e, f: pm.merge_score_pallas(a, bb, c, d, e, f, interpret=True)
        )(
            jnp.asarray(kl), jnp.asarray(kh), jnp.asarray(valid.astype(np.int32)),
            jnp.asarray(logit), jnp.asarray(extra), jnp.asarray(prune),
        )
    assert_outputs(got, want)


@pytest.mark.parametrize(
    "n,lmax,is_bpe,seed",
    [(1, 1, False, 11), (3, 1, False, 12), (1, 3, True, 13), (3, 3, True, 14)],
)
def test_expand_merge_prune_ref_matches_pallas(n, lmax, is_bpe, seed):
    k, b = 5, 12
    beam, tok, cids, pscore, prune = expand_inputs(np.random.RandomState(seed), n, k, b, lmax)
    got = tm.expand_merge_prune_ref(
        torch_planes(beam), torch_planes(tok), torch.as_tensor(cids),
        torch.as_tensor(pscore), torch.as_tensor(prune), is_bpe,
    )

    def one(beam_1, tok_1, cids_1, pscore_1, prune_1):
        return pm.expand_merge_score_pallas(
            beam_1, tok_1, list(cids_1), pscore_1, prune_1, is_bpe, interpret=True
        )

    jbeam = {key: jnp.asarray(val) for key, val in beam.items()}
    jtok = {key: jnp.asarray(val) for key, val in tok.items()}
    if n == 1:
        want = one(
            {key: val[0] for key, val in jbeam.items()},
            {key: val[0] for key, val in jtok.items()},
            jnp.asarray(cids[:, 0]), jnp.asarray(pscore[0]), jnp.float32(prune[0]),
        )
        want = tuple(np.asarray(x)[None] for x in want)
    else:
        want = jax.vmap(one, in_axes=(0, 0, 1, 0, 0))(
            jbeam, jtok, jnp.asarray(cids), jnp.asarray(pscore), jnp.asarray(prune)
        )
    assert_outputs(got, want)


@pytest.mark.parametrize("n,k,b,seed", [(1, 4, 16, 21), (3, 5, 12, 22)])
def test_window_off_chunk_step_matches_pallas(n, k, b, seed):
    """The timeline chunk step: window off (``prune = -inf``), per-utterance token planes.

    ``DEAD + -inf`` must give no NaN and let no DEAD member through: every
    live group-first member keeps its score, everything else stays DEAD.
    """
    rng = np.random.RandomState(seed)
    beam, tok, cids, pscore, _ = expand_inputs(rng, n, k, b, 1)
    tok = chunk_token_planes(rng, tok, 29)
    if n > 1:
        beam["logit"][-1] = DEAD  # an utterance with no live beam: max + prune = DEAD - inf
    prune = np.full(n, -np.inf, dtype=np.float32)
    got = tm.expand_merge_prune_ref(
        torch_planes(beam), torch_planes(tok), torch.as_tensor(cids),
        torch.as_tensor(pscore), torch.as_tensor(prune), False,
    )
    score, merged, _ = (x.numpy() for x in got)
    assert not np.isnan(score).any() and not np.isnan(merged).any()
    valid = (beam["logit"][:, None, :] > -1e29) & (tok["admit"][:, :, None] != 0)
    assert (score[~valid] == DEAD).all()
    assert (score[valid] > -1e29).sum() > 0
    windowed = tm.expand_merge_prune_ref(
        torch_planes(beam), torch_planes(tok), torch.as_tensor(cids),
        torch.as_tensor(pscore), torch.full((n,), -1.0), False,
    )[0].numpy()
    assert ((score > -1e29) | (windowed == DEAD)).all()  # the window only removes
    assert (score > -1e29).sum() > (windowed > -1e29).sum()

    def one(beam_1, tok_1, cids_1, pscore_1, prune_1):
        return pm.expand_merge_score_pallas(
            beam_1, tok_1, list(cids_1), pscore_1, prune_1, False, interpret=True
        )

    jbeam = {key: jnp.asarray(val) for key, val in beam.items()}
    jtok = {key: jnp.asarray(val) for key, val in tok.items()}
    want = jax.vmap(one, in_axes=(0, 0, 1, 0, 0))(
        jbeam, jtok, jnp.asarray(cids), jnp.asarray(pscore), jnp.asarray(prune)
    )
    if n > 1:
        assert_outputs([g[:-1] for g in got], [np.asarray(w)[:-1] for w in want])
        np.testing.assert_array_equal(score[-1], np.asarray(want[0])[-1])  # all DEAD
    else:
        assert_outputs(got, want)

    # the pre-keyed merge with the window off, as the finalize runs it
    kl, kh, mvalid, logit, extra, _ = merge_inputs(rng, n, 1, b)
    margs = torch_merge_args(kl, kh, mvalid, logit, np.zeros_like(extra), prune)
    mscore = tm.merge_prune_ref(*margs)[0].numpy()
    assert not np.isnan(mscore).any() and (mscore[~mvalid] == DEAD).all()


@pytest.mark.parametrize(
    "n,k,b,window,expand",
    [
        (2, 1, 100, False, False),  # the finalize: one column, one block an utterance
        (2, 1, 100, True, True),
        (3, 5, 100, False, True),  # a serving chunk: fewer columns than the largest cluster
        (2, 29, 100, True, True),  # the dense step: columns not a multiple of the cluster
        (2, 3, 40, True, True),  # a beam that is not whole warps
        (2, 6, 37, True, False),
        (1, 2, 260, True, True),  # a beam past 256: several hit words a thread
        (1, 2, 260, False, False),
    ],
)
def test_shapes_the_column_layout_makes_risky_match_pallas(n, k, b, window, expand):
    """Shapes that stress the kernels' cut into clusters, warp groups and hit words.

    Held here on the plain versions against the Pallas kernels; the card
    tests hold the CUDA kernels against the plain versions at the same
    shapes. The last utterance of a batch has no live beam.
    """
    rng = np.random.RandomState(1000 * k + b)
    prune = np.full(n, -3.0 if window else -np.inf, dtype=np.float32)
    if expand:
        beam, tok, cids, pscore, _ = expand_inputs(rng, n, k, b, 1)
        if n > 1:
            beam["logit"][-1] = DEAD
        got = tm.expand_merge_prune(
            torch_planes(beam), torch_planes(tok), torch.as_tensor(cids),
            torch.as_tensor(pscore), torch.as_tensor(prune), False,
        )

        def one(beam_1, tok_1, cids_1, pscore_1, prune_1):
            return pm.expand_merge_score_pallas(
                beam_1, tok_1, list(cids_1), pscore_1, prune_1, False, interpret=True
            )

        want = jax.vmap(one, in_axes=(0, 0, 1, 0, 0))(
            {key: jnp.asarray(val) for key, val in beam.items()},
            {key: jnp.asarray(val) for key, val in tok.items()},
            jnp.asarray(cids), jnp.asarray(pscore), jnp.asarray(prune),
        )
    else:
        kl, kh, valid, logit, extra, _ = merge_inputs(rng, n, k, b)
        if n > 1:
            valid[-1] = False
            logit[-1] = DEAD
        got = tm.merge_prune(*torch_merge_args(kl, kh, valid, logit, extra, prune))
        want = jax.vmap(
            lambda a, bb, c, d, e, f: pm.merge_score_pallas(a, bb, c, d, e, f, interpret=True)
        )(
            jnp.asarray(kl), jnp.asarray(kh), jnp.asarray(valid.astype(np.int32)),
            jnp.asarray(logit), jnp.asarray(extra), jnp.asarray(prune),
        )
    score = got[0].numpy()
    assert not np.isnan(score).any()
    live = n - 1 if n > 1 else n
    assert_outputs([g[:live] for g in got], [np.asarray(w)[:live] for w in want])
    if n > 1:
        assert (score[-1] == DEAD).all()
        np.testing.assert_array_equal(score[-1], np.asarray(want[0])[-1])


def test_cluster_size_is_checked():
    kl, kh, valid, logit, extra, prune = merge_inputs(np.random.RandomState(2), 2, 3, 8)
    args = torch_merge_args(kl, kh, valid, logit, extra, prune)
    for cluster in (0, 1, 2, 4, 8):  # on the CPU the plain version ignores it
        assert torch.equal(tm.merge_prune(*args, cluster=cluster)[0], tm.merge_prune_ref(*args)[0])
    for bad in (3, 16, -1):
        with pytest.raises(ValueError, match="cluster"):
            tm.merge_prune(*args, cluster=bad)
    beam, tok, cids, pscore, prune = expand_inputs(np.random.RandomState(3), 2, 4, 8, 1)
    with pytest.raises(ValueError, match="cluster"):
        tm.expand_merge_prune(
            torch_planes(beam), torch_planes(tok), torch.as_tensor(cids),
            torch.as_tensor(pscore), torch.as_tensor(prune), False, cluster=5,
        )


def test_cpu_wrappers_run_plain_version_and_count_nothing():
    kl, kh, valid, logit, extra, prune = merge_inputs(np.random.RandomState(2), 2, 3, 8)
    args = torch_merge_args(kl, kh, valid, logit, extra, prune)
    before = tm.merge_prune.launches
    got = tm.merge_prune(*args)
    want = tm.merge_prune_ref(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert tm.merge_prune.launches == before

    beam, tok, cids, pscore, prune = expand_inputs(np.random.RandomState(3), 2, 4, 8, 1)
    eargs = (torch_planes(beam), torch_planes(tok), torch.as_tensor(cids),
             torch.as_tensor(pscore), torch.as_tensor(prune), False)
    before = tm.expand_merge_prune.launches
    for g, w in zip(tm.expand_merge_prune(*eargs), tm.expand_merge_prune_ref(*eargs)):
        assert torch.equal(g, w)
    assert tm.expand_merge_prune.launches == before


def test_wrappers_check_dtype_shape_and_contiguity():
    kl, kh, valid, logit, extra, prune = merge_inputs(np.random.RandomState(4), 2, 3, 8)
    args = list(torch_merge_args(kl, kh, valid, logit, extra, prune))
    bad = list(args)
    bad[0] = bad[0].to(torch.int32)
    with pytest.raises(TypeError, match="kl"):
        tm.merge_prune(*bad)
    bad = list(args)
    bad[4] = bad[4][:, :, :4]
    with pytest.raises(ValueError, match="extra"):
        tm.merge_prune(*bad)
    bad = list(args)
    bad[3] = bad[3].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        tm.merge_prune(*bad)
    beam, tok, cids, pscore, prune = expand_inputs(np.random.RandomState(5), 2, 4, 8, 1)
    tplanes = torch_planes(tok)
    tplanes["seed_lo"] = tplanes["seed_lo"].to(torch.int32)
    with pytest.raises(TypeError, match="seed_lo"):
        tm.expand_merge_prune(
            torch_planes(beam), tplanes, torch.as_tensor(cids),
            torch.as_tensor(pscore), torch.as_tensor(prune), False,
        )
