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
* KenLM-keyed tables (models read from KenLM binaries) use KenLM's own
  64-bit chain hash over word ids, mixed down to 32-bit lanes.
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


# --------------------------------------------------------------------------
# KenLM-compatible hashing (KenLM binary models, models/kenlm_bin.py)
#
# KenLM's PROBING format keys its n-gram hash tables by a 64-bit rolling
# hash over word ids (kenlm lm/search_hashed.hh ``detail::CombineWordHash``)
# and its vocabulary by MurmurHash64A of the word string (kenlm
# lm/vocab.cc ``detail::HashForVocab``). Reading those tables means
# reproducing both hashes exactly: on the host in numpy uint64; in the
# engine as u32 lane pairs (:func:`kenlm_chain`, :func:`kenlm_chain_t`),
# the 64-bit multiply spelled out in 32x32->64 pieces.
# --------------------------------------------------------------------------
KENLM_MUL_A = 8978948897894561157  # CombineWordHash multipliers
KENLM_MUL_B = 17894857484156487943
KENLM_BASE_SEED = 0x243F6A88  # mix32_pair seed of a KenLM-keyed table's base slot
_MASK64 = (1 << 64) - 1


def murmur64(data: bytes, seed: int = 0) -> int:
    """MurmurHash64A (Appleby) over ``data`` — kenlm's vocab string hash."""
    m = 0xC6A4A7935BD1E995
    r = 47
    h = (seed ^ ((len(data) * m) & _MASK64)) & _MASK64
    n8 = len(data) & ~7
    for i in range(0, n8, 8):
        k = int.from_bytes(data[i : i + 8], "little")
        k = (k * m) & _MASK64
        k ^= k >> r
        k = (k * m) & _MASK64
        h = ((h ^ k) * m) & _MASK64
    tail = data[n8:]
    if tail:
        h ^= int.from_bytes(tail, "little")
        h = (h * m) & _MASK64
    h ^= h >> r
    h = (h * m) & _MASK64
    h ^= h >> r
    return h


def kenlm_chain_host(keys: "np.ndarray") -> "np.ndarray":
    """KenLM n-gram hash over NATURAL-order id rows ``[..., n]`` (u64).

    kenlm folds from the PREDICTED (newest) word backward through the
    context: its hashed search starts the node at the new word's id and
    applies ``CombineWordHash(c, w) = c * A ^ (w + 1) * B`` (mod 2^64)
    per context word, nearest first (``lm/model.cc`` ScoreExceptBackoff;
    ``lm/search_hashed.cc`` ReadNGrams stores keys over the
    REVERSED-order ``vocab_ids`` the ARPA reader fills). So for a
    natural-order row (w1..wn): ``chain = fold(combine, start=wn) over
    w(n-1)..w1``. A fold run oldest-first stays self-consistent across a
    reader, a writer and a scorer of one's own, so round-trip tests cannot
    see it; authentic kenlm PROBING binaries would miss every n>=2-gram.
    """
    keys = np.asarray(keys)
    with np.errstate(over="ignore"):
        h = keys[..., -1].astype(np.uint64)
        a = np.uint64(KENLM_MUL_A)
        b = np.uint64(KENLM_MUL_B)
        one = np.uint64(1)
        for j in range(keys.shape[-1] - 2, -1, -1):
            w = keys[..., j].astype(np.uint64)
            h = (h * a) ^ ((w + one) * b)
    return h


def umul32_wide(xp: Any, a: Any, b: Any) -> Tuple[Any, Any]:
    """Full 32x32 -> 64 unsigned multiply as a (lo, hi) u32 pair."""
    mask = _u32(xp, 0xFFFF)
    a0 = a & mask
    a1 = a >> _u32(xp, 16)
    b0 = b & mask
    b1 = b >> _u32(xp, 16)
    m00 = a0 * b0
    m01 = a0 * b1
    m10 = a1 * b0
    m11 = a1 * b1
    mid = (m00 >> _u32(xp, 16)) + (m01 & mask) + (m10 & mask)
    lo = (m00 & mask) | ((mid & mask) << _u32(xp, 16))
    hi = m11 + (m01 >> _u32(xp, 16)) + (m10 >> _u32(xp, 16)) + (mid >> _u32(xp, 16))
    return lo, hi


def _mul64_by_const(xp, lo, hi, c_lo: int, c_hi: int):
    """Low 64 bits of a (lo, hi) u32-pair value times a 64-bit constant."""
    p_lo, p_hi = umul32_wide(xp, lo, _u32(xp, c_lo))
    p_hi = p_hi + lo * _u32(xp, c_hi) + hi * _u32(xp, c_lo)
    return p_lo, p_hi


def kenlm_chain(xp: Any, keys: Any) -> Tuple[Any, Any]:
    """KenLM n-gram hash over id rows ``[..., n]`` as a (lo, hi) u32 pair.

    Bit-identical to :func:`kenlm_chain_host` for ids below ``2**32 - 1``;
    ``w + 1`` is taken in u32 (it wraps at ``0xFFFFFFFF``), as the device
    computes it.
    """
    keys = xp.asarray(keys)
    a_lo = KENLM_MUL_A & M32
    a_hi = KENLM_MUL_A >> 32
    b_lo = KENLM_MUL_B & M32
    b_hi = KENLM_MUL_B >> 32
    h_lo = keys[..., -1].astype(xp.uint32)
    h_hi = xp.zeros_like(h_lo)
    for j in range(keys.shape[-1] - 2, -1, -1):
        w1 = keys[..., j].astype(xp.uint32) + _u32(xp, 1)
        t_lo, t_hi = _mul64_by_const(xp, h_lo, h_hi, a_lo, a_hi)
        u_lo, u_hi = umul32_wide(xp, w1, _u32(xp, b_lo))
        u_hi = u_hi + w1 * _u32(xp, b_hi)
        h_lo = t_lo ^ u_lo
        h_hi = t_hi ^ u_hi
    return h_lo, h_hi


def mix32_pair(xp: Any, lo: Any, hi: Any, seed: Any) -> Any:
    """Seeded 32-bit mix of a u32 hash pair (murmur3 finalizer core).

    KenLM-keyed probe tables derive their base slot and both fingerprint
    lanes from the one 64-bit kenlm key; independent seeds keep the three
    derived values uncorrelated, and a build-time fingerprint collision can
    bump the seeds without touching the key (the contract of
    :func:`fnv1a_seeded` for id-keyed tables).
    """
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


def _mul_lo32_t(a: torch.Tensor, c: int) -> torch.Tensor:
    """Low 32 bits of lanes ``a`` times a Python-int u32 ``c``, from 16-bit halves of ``c``."""
    return (a * (c & 0xFFFF) + (((a * (c >> 16)) & 0xFFFF) << 16)) & M32


def mix32_pair_t(lo: torch.Tensor, hi: torch.Tensor, seed: int) -> torch.Tensor:
    """Torch :func:`mix32_pair` with a Python-int seed."""
    h = lo ^ _mul_lo32_t(hi, 0x85EBCA6B) ^ (int(seed) & M32)
    h = h ^ (h >> 16)
    h = _mul_lo32_t(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul_lo32_t(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def umul32_wide_t(a: torch.Tensor, c: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Torch :func:`umul32_wide` of lanes ``a`` by a Python-int u32 ``c``.

    Built from 16-bit halves, so every product and sum stays below
    ``2**34``: no int64 overflows or goes negative.
    """
    a0, a1 = a & 0xFFFF, a >> 16
    c0, c1 = c & 0xFFFF, c >> 16
    m00, m01, m10, m11 = a0 * c0, a0 * c1, a1 * c0, a1 * c1
    mid = (m00 >> 16) + (m01 & 0xFFFF) + (m10 & 0xFFFF)
    lo = (m00 & 0xFFFF) | ((mid & 0xFFFF) << 16)
    hi = (m11 + (m01 >> 16) + (m10 >> 16) + (mid >> 16)) & M32
    return lo, hi


def kenlm_chain_t(keys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Torch :func:`kenlm_chain`: ``(lo, hi)`` int64 lanes of each row's chain.

    ``keys``: integer ``[..., n]``; each id is taken as its u32 bit pattern
    and ``w + 1`` wraps in u32, as in :func:`kenlm_chain`. Every 64-bit
    product is built from 32-bit pieces of masked lanes and 16-bit halves of
    the constants, so no int64 overflows and no right shift meets a
    negative value.
    """
    a_lo, a_hi = KENLM_MUL_A & M32, KENLM_MUL_A >> 32
    b_lo, b_hi = KENLM_MUL_B & M32, KENLM_MUL_B >> 32
    h_lo = keys[..., -1].to(torch.int64) & M32
    h_hi = torch.zeros_like(h_lo)
    for j in range(keys.shape[-1] - 2, -1, -1):
        w1 = ((keys[..., j].to(torch.int64) & M32) + 1) & M32
        t_lo, t_hi = umul32_wide_t(h_lo, a_lo)
        t_hi = (t_hi + _mul_lo32_t(h_lo, a_hi) + _mul_lo32_t(h_hi, a_lo)) & M32
        u_lo, u_hi = umul32_wide_t(w1, b_lo)
        u_hi = (u_hi + _mul_lo32_t(w1, b_hi)) & M32
        h_lo, h_hi = t_lo ^ u_lo, t_hi ^ u_hi
    return h_lo, h_hi
