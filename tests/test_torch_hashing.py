"""Torch hash twins are bit-equal to the JAX package's numpy hashing.

The port carries uint32 lanes as int64 tensors masked to 32 bits; every
twin must give exactly the numpy uint32 result, wraparound included.
"""
import numpy as np
import pytest
import torch

from pyctcdecode_torch.ops import hashing as th
from pyctcdecode_tpu.ops import hashing as jh

from .torch_cases import one_torch_thread  # noqa: F401  (autouse fixture)

_EDGES = np.array([0, 1, 2, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, 0xFFFFFFFF], dtype=np.uint32)


def _u32(rng, shape):
    vals = rng.randint(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32)
    flat = vals.reshape(-1)
    flat[: min(len(_EDGES), flat.size)] = _EDGES[: flat.size]
    return vals


def _t(arr):
    return th.as_lane(arr)


def _eq(torch_out, np_out):
    np.testing.assert_array_equal(torch_out.numpy(), np_out.astype(np.int64))


@pytest.mark.parametrize("seed", [0, 1])
def test_lane_functions_bit_equal(seed):
    rng = np.random.RandomState(seed)
    a, b, c, d = (_u32(rng, (64,)) for _ in range(4))
    with np.errstate(over="ignore"):
        _eq(th.mix4_t(_t(a), _t(b), _t(c), _t(d)), jh.mix4(np, a, b, c, d))
        lo, hi = jh.hash_extend_char(np, a, b, c % np.uint32(4096))
        tlo, thi = th.hash_extend_char_t(_t(a), _t(b), _t(c % np.uint32(4096)))
        _eq(tlo, lo)
        _eq(thi, hi)
        lo, hi = jh.hash_text_commit(np, a, b, c, d)
        tlo, thi = th.hash_text_commit_t(_t(a), _t(b), _t(c), _t(d))
        _eq(tlo, lo)
        _eq(thi, hi)
        for seed_val in (0, 0x243F6A88, 0xFFFFFFFF):
            _eq(th.mix32_pair_t(_t(a), _t(b), seed_val), jh.mix32_pair(np, a, b, np.uint32(seed_val)))


@pytest.mark.parametrize("n", [1, 2, 3, 5])
def test_fnv_bit_equal(n):
    rng = np.random.RandomState(n)
    ids = rng.randint(-1, 2**31 - 1, size=(50, n)).astype(np.int32)
    ids[0] = -1  # the -1 context pad hashes as 0xFFFFFFFF
    ids_t = torch.as_tensor(ids)
    with np.errstate(over="ignore"):
        _eq(th.fnv1a_t(ids_t), jh.fnv1a(np, ids))
        for seed_val in (0x811C9DC5 ^ 0x5BD1E995, 0, 0xFFFFFFFF):
            _eq(th.fnv1a_seeded_t(ids_t, seed_val), jh.fnv1a_seeded(np, ids, np.uint32(seed_val)))


def test_numpy_copies_match_reference():
    """The port's numpy functions are the reference's, bit for bit."""
    rng = np.random.RandomState(7)
    a, b, c, d = (_u32(rng, (32,)) for _ in range(4))
    ids = rng.randint(0, 1000, size=(32, 3)).astype(np.int32)
    with np.errstate(over="ignore"):
        np.testing.assert_array_equal(th.mix4(np, a, b, c, d), jh.mix4(np, a, b, c, d))
        np.testing.assert_array_equal(th.fnv1a(np, ids), jh.fnv1a(np, ids))
        np.testing.assert_array_equal(
            th.fnv1a_seeded(np, ids, np.uint32(5)), jh.fnv1a_seeded(np, ids, np.uint32(5))
        )
        np.testing.assert_array_equal(
            th.hash_text_commit(np, a, b, c, d)[0], jh.hash_text_commit(np, a, b, c, d)[0]
        )
