"""uint32 hashing shared by host-side table builders and the device engine.

The device engine replaces the reference's *string*-keyed beam merging
(ref ``decoder.py:211-224``) with 2x32-bit rolling hashes over committed
words and in-progress partial words. Host builders (numpy) and the device
step (torch) must produce bit-identical hashes.

* The numpy functions take an array-module parameter ``xp`` (always
  ``numpy`` here) and compute in uint32 with wraparound.
* The torch twins (``*_t``) carry every lane as an ``int64`` tensor holding
  a value in ``[0, 2**32)``: torch's ``uint32`` supports few operations.
  Each multiply or add is masked with ``& 0xFFFFFFFF``; a 32x32 product
  may wrap the int64, but its low 32 bits stay exact. Right shifts act on
  masked (non-negative) values, so they are logical shifts.

Hash design:

* characters are folded into the partial-word hash with two independent
  multiplicative lanes (:data:`CH_A`, :data:`CH_B`),
* a committed word's hash pair is folded into the text hash pair with a
  second multiplier pair (:data:`TXT_A`, :data:`TXT_B`),
* n-gram table slots use FNV-1a over the key's word ids.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch

# FNV-1a (32 bit)
FNV_OFFSET = 2166136261
FNV_PRIME = 16777619

# char-into-partial multipliers (two independent lanes)
CH_A = 31
CH_B = 1000003

# word-into-text multipliers
TXT_A = 2654435761
TXT_B = 40503

# xor salt applied to a word hash before folding it into the text hash
TXT_SALT = 0x9E3779B9

MIX_PRIME = 0x01000193
M32 = 0xFFFFFFFF


def _u32(xp, v):
    return xp.asarray(v, dtype=xp.uint32)


# --------------------------------------------------------------------------
# numpy (host table builders)
# --------------------------------------------------------------------------
def fnv1a(xp: Any, ids: Any, valid_len: Optional[Any] = None) -> Any:
    """FNV-1a over the trailing dimension of an int array.

    ``ids``: integer array ``[..., n]``. When ``valid_len`` (broadcastable
    to ``[...]``) is given, only the last ``valid_len`` elements contribute
    (right-aligned keys); otherwise all ``n`` do.
    """
    ids = xp.asarray(ids)
    n = ids.shape[-1]
    h = xp.full(ids.shape[:-1], FNV_OFFSET, dtype=xp.uint32)
    prime = _u32(xp, FNV_PRIME)
    for j in range(n):
        x = ids[..., j].astype(xp.uint32)
        hj = (h ^ x) * prime
        if valid_len is None:
            h = hj
        else:
            # position j participates when j >= n - valid_len
            h = xp.where(xp.asarray(valid_len) > (n - 1 - j), hj, h)
    return h


def fnv1a_seeded(xp: Any, ids: Any, seed: Any) -> Any:
    """FNV-1a over the trailing dimension with a caller-supplied offset basis.

    Used for the n-gram tables' fingerprint lanes: the probe-slot hash and
    the two fingerprint lanes must be independent, and a table that detects
    an in-bucket fingerprint collision at build time re-derives its lanes
    from bumped seeds.
    """
    ids = xp.asarray(ids)
    n = ids.shape[-1]
    h = xp.broadcast_to(
        xp.asarray(seed, dtype=xp.uint32), ids.shape[:-1]
    ).astype(xp.uint32)
    prime = _u32(xp, FNV_PRIME)
    for j in range(n):
        h = (h ^ ids[..., j].astype(xp.uint32)) * prime
    return h


def hash_extend_char(xp: Any, h_lo: Any, h_hi: Any, char_id: Any) -> Tuple[Any, Any]:
    """Fold one character id into a partial-word hash pair."""
    c = char_id.astype(xp.uint32) if hasattr(char_id, "astype") else _u32(xp, char_id)
    one = _u32(xp, 1)
    lo = h_lo * _u32(xp, CH_A) + c + one
    hi = h_hi * _u32(xp, CH_B) + c + one
    return lo, hi


def mix4(xp: Any, a: Any, b: Any, c: Any, d: Any) -> Any:
    """Fold four uint32 streams into one uint32 lane (beam merge keys)."""
    h = a * _u32(xp, MIX_PRIME) ^ b
    h = h * _u32(xp, MIX_PRIME) ^ c
    return h * _u32(xp, MIX_PRIME) ^ d


def hash_text_commit(xp: Any, t_lo: Any, t_hi: Any, w_lo: Any, w_hi: Any) -> Tuple[Any, Any]:
    """Fold a committed word's hash pair into the text hash pair."""
    salt = _u32(xp, TXT_SALT)
    lo = t_lo * _u32(xp, TXT_A) + (w_lo ^ salt)
    hi = t_hi * _u32(xp, TXT_B) + (w_hi ^ salt)
    return lo, hi


def mix32_pair(xp: Any, lo: Any, hi: Any, seed: Any) -> Any:
    """Seeded 32-bit mix of a u32 hash pair (murmur3 finalizer core)."""
    h = lo ^ (hi * _u32(xp, 0x85EBCA6B)) ^ xp.asarray(seed, dtype=xp.uint32)
    h ^= h >> _u32(xp, 16)
    h = h * _u32(xp, 0x85EBCA6B)
    h ^= h >> _u32(xp, 13)
    h = h * _u32(xp, 0xC2B2AE35)
    h ^= h >> _u32(xp, 16)
    return h


# --------------------------------------------------------------------------
# torch twins: int64 tensors holding uint32 values
# --------------------------------------------------------------------------
def as_lane(x: Any, device: Optional[torch.device] = None) -> torch.Tensor:
    """Any integer array or tensor -> int64 tensor of its uint32 bit pattern."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device or x.device, dtype=torch.int64) & M32
    arr = np.asarray(x)
    if arr.dtype.kind in "iu":
        arr = arr.astype(np.int64) & M32
    return torch.as_tensor(arr, dtype=torch.int64, device=device)


def fnv1a_t(ids: torch.Tensor) -> torch.Tensor:
    """Torch :func:`fnv1a` (all positions) over ``[..., n]`` integer ids."""
    h = torch.full(ids.shape[:-1], FNV_OFFSET, dtype=torch.int64, device=ids.device)
    for j in range(ids.shape[-1]):
        h = ((h ^ (ids[..., j].to(torch.int64) & M32)) * FNV_PRIME) & M32
    return h


def fnv1a_seeded_t(ids: torch.Tensor, seed: int) -> torch.Tensor:
    """Torch :func:`fnv1a_seeded` with a Python-int seed."""
    h = torch.full(ids.shape[:-1], int(seed) & M32, dtype=torch.int64, device=ids.device)
    for j in range(ids.shape[-1]):
        h = ((h ^ (ids[..., j].to(torch.int64) & M32)) * FNV_PRIME) & M32
    return h


def hash_extend_char_t(
    h_lo: torch.Tensor, h_hi: torch.Tensor, char_id: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Torch :func:`hash_extend_char` (``char_id`` non-negative)."""
    c = char_id.to(torch.int64) & M32
    lo = (h_lo * CH_A + c + 1) & M32
    hi = (h_hi * CH_B + c + 1) & M32
    return lo, hi


def mix4_t(a: Any, b: Any, c: Any, d: Any) -> torch.Tensor:
    """Torch :func:`mix4`; operands are int64 lanes or Python ints."""
    h = ((a * MIX_PRIME) & M32) ^ b
    h = ((h * MIX_PRIME) & M32) ^ c
    return ((h * MIX_PRIME) & M32) ^ d


def hash_text_commit_t(
    t_lo: torch.Tensor, t_hi: torch.Tensor, w_lo: torch.Tensor, w_hi: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Torch :func:`hash_text_commit`."""
    lo = (t_lo * TXT_A + (w_lo ^ TXT_SALT)) & M32
    hi = (t_hi * TXT_B + (w_hi ^ TXT_SALT)) & M32
    return lo, hi


def mix32_pair_t(lo: torch.Tensor, hi: torch.Tensor, seed: int) -> torch.Tensor:
    """Torch :func:`mix32_pair` with a Python-int seed."""
    h = lo ^ ((hi * 0x85EBCA6B) & M32) ^ (int(seed) & M32)
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & M32
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & M32
    return h ^ (h >> 16)
