"""Row reads of the LM tables: CUDA kernels and plain twins.

Replaces the Pallas row gather of the JAX reference package (the
``gather_kernel`` of its ``scripts/pallas_gather_probe.py``), written there
against the ``[beams]``-row gathers of every decode step: the trie-row fetch
and one bucket-row read per n-gram order >= 2. Two entry points:

* :func:`gather_rows`: ``out[q, :width] = table[idx[q], slot[q] * stride :
  slot[q] * stride + width]``; with no slot, the whole-row copy
  ``table[idx]``. :func:`~pyctcdecode_torch.models.device_tables.trie_fetch_rows`
  reads a node's own words out of the multi-node trie rows with it.
* :func:`probe_rows`: every order's bucket probe of one
  :func:`~pyctcdecode_torch.models.device_tables.lm_score_words` call in one
  launch: the three hashes of each query (base slot and two fingerprint
  lanes), the read of bucket row ``h % size`` and the fingerprint readout,
  returning ``(found, prob, backoff)`` per order. The bucket rows are never
  written anywhere. Each table carries its hash mode: ``"fnv"`` (seeded
  FNV-1a over the ids; tables built from ARPA or ``.ctclm`` models) or
  ``"kenlm64"`` (KenLM's 64-bit chain over the ids; tables built from a
  KenLM binary's stored hashes): the base slot mixes both halves of the
  chain, and each fingerprint lane is a seeded bijection of one half, so the
  two lanes carry all 64 bits (see
  :func:`~pyctcdecode_torch.models.device_tables.build_fp_table_from_hashes`).
  A table may hold a row window of a larger one (``"row0"``, and the
  bucket's own row count): the base slot is still ``h % size`` over the
  whole table, and a query whose slot lies outside the window answers
  ``found = False``, ``prob = backoff = 0``, so the answers of a plane's
  windows sum to the whole plane's (the row-sharded LM of
  :mod:`pyctcdecode_torch.parallel`).

What bounds them on the H100: bytes by the roofline (each row read once,
each result written once), but at a decode step's size (utterances x beams
queries) a launch costs more than its copy, and a gathered row is read again
by a chain of small PyTorch kernels. The kernels (``csrc/gather.cu``) answer
with fewer launches and fewer bytes: the slot select writes 52 of a trie
row's 256 bytes, and the probe keeps a whole 512-byte bucket row in one
warp's registers (one 16-byte vector a lane) and writes 9 bytes per query
and order.

On CPU tensors each wrapper runs its plain version (:func:`gather_rows_ref`,
:func:`probe_rows_ref`); on CUDA tensors it launches the kernel or raises.
``<wrapper>.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Sequence, Tuple

import torch

from .hashing import KENLM_BASE_SEED, M32, fnv1a_seeded_t, fnv1a_t, kenlm_chain_t, mix32_pair_t
from .merge import _check, _launch, _launch_device, _ptr

VECTOR_BYTES = 16  # the kernels move int4 vectors where the shapes allow
FP_MAX = 0xFFFFFFFE  # fingerprint lanes are clamped below the empty-slot sentinel
PROBE_GEOMETRY = (16, 64, 128)  # (slots, sub-block words, row words) the probe kernel takes
PROBE_MAX_TABLES = 8
HASH_MODES = ("fnv", "kenlm64")  # a table's hash mode, by its code in the kernel's launch

Probe = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


# --------------------------------------------------------------------------
# plain PyTorch versions
# --------------------------------------------------------------------------
def gather_rows_ref(table: torch.Tensor, idx: torch.Tensor, slot: Optional[torch.Tensor] = None,
                    stride: Optional[int] = None, width: Optional[int] = None) -> torch.Tensor:
    """Plain version of :func:`gather_rows` (any device)."""
    row_words = table.shape[1]
    if slot is None and width in (None, row_words):
        return table[idx]
    start = idx * row_words
    if slot is not None:
        start = start + slot * (row_words if stride is None else stride)
    cols = torch.arange(row_words if width is None else width, device=table.device)
    return table.reshape(-1)[start[..., None] + cols]


def hash_mode_code(tab: Dict) -> int:
    """The kernel's code of ``tab``'s hash mode (``"fnv"`` when unset); raises on any other."""
    mode = tab.get("hash_mode", "fnv")
    if mode not in HASH_MODES:
        raise ValueError(f"unknown hash_mode {mode!r}; expected one of {HASH_MODES}")
    return HASH_MODES.index(mode)


def query_hashes(tab: Dict, query: torch.Tensor) -> Probe:
    """Base hash + clamped fingerprint lanes for queries ``[..., n]``.

    Mode ``"fnv"`` hashes the id tuple directly; mode ``"kenlm64"`` first
    folds the ids through KenLM's 64-bit chain (the only key a PROBING
    binary stores): the base hash mixes both halves, each lane one half.
    """
    if HASH_MODES[hash_mode_code(tab)] == "kenlm64":
        klo, khi = kenlm_chain_t(query)
        h = mix32_pair_t(klo, khi, KENLM_BASE_SEED)
        lo = mix32_pair_t(klo, 0, tab["seed_lo"])
        hi = mix32_pair_t(khi, 0, tab["seed_hi"])
    else:
        h = fnv1a_t(query)
        lo = fnv1a_seeded_t(query, tab["seed_lo"])
        hi = fnv1a_seeded_t(query, tab["seed_hi"])
    return h, lo.clamp(max=FP_MAX), hi.clamp(max=FP_MAX)


def bucket_readout(rows: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor, valid: torch.Tensor,
                   slots: int, sub_width: int) -> Probe:
    """(found, prob, backoff) from bucket rows ``[..., n_sub * sub_width]``.

    A sub-block is ``[lo x slots | hi x slots | prob x slots | backoff x
    slots]``. Residents of a bucket have pairwise-distinct 64-bit
    fingerprints, so each masked sum touches at most one slot of at most one
    sub-block.
    """
    s = slots
    found = prob = backoff = None
    for sub in range(rows.shape[-1] // sub_width):
        blk = rows[..., sub * sub_width : (sub + 1) * sub_width]
        rl = blk[..., :s].to(torch.int64) & M32
        rh = blk[..., s : 2 * s].to(torch.int64) & M32
        eq = (rl == lo[..., None]) & (rh == hi[..., None]) & valid[..., None]
        f = eq.any(dim=-1)
        pb = blk[..., 2 * s : 3 * s].view(torch.float32)
        bb = blk[..., 3 * s :].view(torch.float32)
        p = torch.where(eq, pb, 0.0).sum(dim=-1)
        b = torch.where(eq, bb, 0.0).sum(dim=-1)
        found = f if found is None else (found | f)
        prob = p if prob is None else (prob + p)
        backoff = b if backoff is None else (backoff + b)
    return found, prob, backoff


def probe_rows_ref(full: torch.Tensor, ctx_len: torch.Tensor, tables: Sequence[Dict],
                   slots: int, sub_width: int) -> Probe:
    """Plain version of :func:`probe_rows` (any device): one probe per order."""
    order = full.shape[-1]
    per_order = []
    for t, tab in enumerate(tables):
        n = t + 2
        h, lo, hi = query_hashes(tab, full[..., order - n :])
        local = h % tab["size"] - tab.get("row0", 0)
        mine = (local >= 0) & (local < tab["bucket"].shape[0])
        rows = gather_rows_ref(tab["bucket"], local.clamp(0, tab["bucket"].shape[0] - 1))
        per_order.append(bucket_readout(rows, lo, hi, ((ctx_len + 1) >= n) & mine, slots, sub_width))
    found, prob, backoff = (torch.stack(planes) for planes in zip(*per_order))
    return found, prob, backoff


# --------------------------------------------------------------------------
# wrappers
# --------------------------------------------------------------------------
@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    """Build (first use) and load ``csrc/gather.cu``; declare its C signatures."""
    from ..csrc.build import load

    lib = load("gather.cu")
    vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.gather_rows_launch.argtypes = [vp, vp, vp, vp, cll, ci, ci, ci, vp]
    lib.gather_rows_launch.restype = ci
    lib.probe_rows_launch.argtypes = [vp] * 12 + [cll] + [ci] * 4 + [vp]
    lib.probe_rows_launch.restype = ci
    return lib


def gather_rows(table: torch.Tensor, idx: torch.Tensor, slot: Optional[torch.Tensor] = None,
                stride: Optional[int] = None, width: Optional[int] = None) -> torch.Tensor:
    """``out[..., :width] = table[idx[...], slot[...] * stride : slot[...] * stride + width]``, bit-exact.

    ``table``: int32 ``[R, W]``, contiguous; ``idx``: int64 of any shape,
    contiguous, on ``table``'s device; ``slot``: like ``idx``, or None for
    slot 0; ``stride`` (default ``W``) and ``width`` (default ``stride``) in
    int32 words. With neither slot nor width this is the whole-row copy
    ``table[idx]``, and ``W * 4`` must be a multiple of 16 bytes. Returns
    int32 ``[*idx.shape, width]``.

    Contract: every index lies in ``[0, R)`` and every slot in ``[0, W //
    stride)``. The kernel neither clamps nor checks (a check would read the
    indices back and stall the decode step); the engine's indices are in
    range by construction (trie node ids from trie entries).
    """
    if not isinstance(table, torch.Tensor):
        raise TypeError(f"table: expected a torch.Tensor, got {type(table).__name__}")
    if table.dtype != torch.int32:
        raise TypeError(f"table: expected torch.int32, got {table.dtype}")
    if table.dim() != 2:
        raise ValueError(f"table: expected [rows, width], got shape {tuple(table.shape)}")
    dev = table.device
    if not table.is_contiguous():
        raise ValueError("table: must be contiguous")
    _check("idx", idx, torch.int64, None, dev)
    row_words = table.shape[1]
    whole = slot is None and stride is None and width is None
    if whole and (row_words == 0 or (row_words * table.element_size()) % VECTOR_BYTES):
        raise ValueError(
            f"table: row width {row_words} int32 words is not a multiple of {VECTOR_BYTES} bytes"
        )
    stride = row_words if stride is None else int(stride)
    width = stride if width is None else int(width)
    if not 0 < width <= stride <= row_words:
        raise ValueError(f"need 0 < width <= stride <= row width; got {width}, {stride}, {row_words}")
    if slot is not None:
        _check("slot", slot, torch.int64, idx.shape, dev)
    if dev.type == "cpu":
        return gather_rows_ref(table, idx, slot, stride, width)
    _launch_device(dev)
    out = torch.empty((*idx.shape, width), dtype=torch.int32, device=dev)
    if idx.numel() == 0:
        return out
    _launch(
        "gather_rows", dev, _library().gather_rows_launch,
        _ptr(table), _ptr(idx), None if slot is None else _ptr(slot), _ptr(out),
        idx.numel(), row_words, stride, width,
    )
    gather_rows.launches += 1
    return out


gather_rows.launches = 0


def probe_rows(full: torch.Tensor, ctx_len: torch.Tensor, tables: Sequence[Dict],
               slots: int, sub_width: int) -> Probe:
    """Probe every n-gram order >= 2 for queries ``full``: one launch, bit-exact.

    ``full``: int64 ``[..., order]`` word ids, right-aligned (-1 pad);
    ``ctx_len``: int64 ``[...]``; ``tables``: ``order - 1`` dicts
    ``{"bucket": int32 [rows, row words], "size", "seed_lo", "seed_hi"}``
    and optionally ``"hash_mode"`` (``"fnv"``, the default, or ``"kenlm64"``;
    tables of both modes may mix in one call) and ``"row0"`` (default 0:
    the bucket holds rows ``[row0, row0 + rows)`` of a table of ``size``
    rows; without it the whole table, ``rows == size``), table ``t`` keyed
    by the last ``t + 2`` ids; ``slots`` / ``sub_width``:
    the bucket geometry (slots per sub-block, words per sub-block). A query
    is valid at order n when ``ctx_len + 1 >= n``. Returns ``(found bool,
    prob f32, backoff f32)``, each ``[order - 1, ...]``.

    Contract: ``size`` is the whole table's row count (the bucket's own
    without ``"row0"``); a query's row ``h % size`` is read only where it
    lies in the window. Nothing else is checked in the kernel.
    """
    if not isinstance(full, torch.Tensor):
        raise TypeError(f"full: expected a torch.Tensor, got {type(full).__name__}")
    dev = full.device
    _check("full", full, torch.int64, None, dev)
    if full.dim() < 1:
        raise ValueError("full: expected [..., order] ids")
    _check("ctx_len", ctx_len, torch.int64, full.shape[:-1], dev)
    order = full.shape[-1]
    if order < 2 or len(tables) != order - 1:
        raise ValueError(f"tables: expected {order - 1} for ids of width {order}, got {len(tables)}")
    for t, tab in enumerate(tables):
        hash_mode_code(tab)
        _check(f"tables[{t}]['bucket']", tab["bucket"], torch.int32, None, dev)
        whole = "row0" not in tab
        if (tab["bucket"].dim() != 2 or tab["bucket"].shape[0] < 1 or tab.get("row0", 0) < 0
                or (whole and tab["bucket"].shape[0] != tab["size"])):
            raise ValueError(f"tables[{t}]: bucket {tuple(tab['bucket'].shape)} is not a window of "
                             f"{tab['size']} rows")
        if tab["bucket"].shape[1] % sub_width or sub_width != 4 * slots:
            raise ValueError(f"tables[{t}]: row of {tab['bucket'].shape[1]} words is not whole sub-blocks")
    if dev.type == "cpu":
        return probe_rows_ref(full, ctx_len, tables, slots, sub_width)
    _launch_device(dev)
    geometry = {(slots, sub_width, tab["bucket"].shape[1]) for tab in tables}
    if geometry != {PROBE_GEOMETRY} or len(tables) > PROBE_MAX_TABLES:
        raise ValueError(
            f"probe_rows: the kernel takes up to {PROBE_MAX_TABLES} tables of geometry "
            f"{PROBE_GEOMETRY}; got {len(tables)} of {sorted(geometry)}"
        )
    lead = tuple(ctx_len.shape)
    found = torch.empty((order - 1, *lead), dtype=torch.bool, device=dev)
    prob = torch.empty((order - 1, *lead), dtype=torch.float32, device=dev)
    backoff = torch.empty((order - 1, *lead), dtype=torch.float32, device=dev)
    if ctx_len.numel() == 0:
        return found, prob, backoff
    n_tab = order - 1
    buckets = (ctypes.c_void_p * n_tab)(*(tab["bucket"].data_ptr() for tab in tables))
    sizes, seeds_lo, seeds_hi = (
        (ctypes.c_uint32 * n_tab)(*(int(tab[key]) & M32 for tab in tables))
        for key in ("size", "seed_lo", "seed_hi")
    )
    row0s = (ctypes.c_uint32 * n_tab)(*(int(tab.get("row0", 0)) for tab in tables))
    rows = (ctypes.c_uint32 * n_tab)(*(int(tab["bucket"].shape[0]) for tab in tables))
    modes = (ctypes.c_uint32 * n_tab)(*(hash_mode_code(tab) for tab in tables))
    _launch(
        "probe_rows", dev, _library().probe_rows_launch,
        buckets, sizes, row0s, rows, seeds_lo, seeds_hi, modes, _ptr(full), _ptr(ctx_len), _ptr(found),
        _ptr(prob), _ptr(backoff), ctx_len.numel(), order, *PROBE_GEOMETRY,
    )
    probe_rows.launches += 1
    return found, prob, backoff


probe_rows.launches = 0
