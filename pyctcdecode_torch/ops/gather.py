"""Row gather ``out[..., :] = table[idx[...], :]``: CUDA kernel and plain twin.

Replaces the Pallas row gather of the JAX reference package (the
``gather_kernel`` of its ``scripts/pallas_gather_probe.py``), written there
against the ``[beams]``-row gathers of every decode step: the trie-row fetch
and one bucket-row read per n-gram order >= 2. In this package those are
:func:`~pyctcdecode_torch.models.device_tables.trie_fetch_rows` and
:func:`~pyctcdecode_torch.models.device_tables.probe_fp`, and both take their
rows through :func:`gather_rows`.

What bounds it on the H100: bytes, each gathered row read once and written
once plus the indices; there is no arithmetic. At the probe's own size (38 400
rows of 256 B) that is about 20 MB, microseconds at the card's memory rate; at
a decode step's size (utterances x beams rows) the launch outweighs the copy.
The kernel (``csrc/gather.cu``) moves 16-byte vectors, neighbouring lanes on
neighbouring addresses of one row, in a grid-stride loop; keeping many rows
in flight per warp with asynchronous copies is later work.

On CPU tensors the wrapper runs the plain version (:func:`gather_rows_ref`);
on CUDA tensors it launches the kernel or raises. ``gather_rows.launches``
counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .merge import _launch_device, _ptr, _raise_on

VECTOR_BYTES = 16  # the kernel moves int4 vectors


def gather_rows_ref(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`gather_rows` (any device)."""
    return table[idx]


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    """Build (first use) and load ``csrc/gather.cu``; declare its C signature."""
    from ..csrc.build import load

    lib = load("gather.cu")
    vp = ctypes.c_void_p
    lib.gather_rows_launch.argtypes = [vp, vp, vp, ctypes.c_longlong, ctypes.c_int, vp]
    lib.gather_rows_launch.restype = ctypes.c_int
    return lib


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of ``table`` at ``idx``: ``out[..., :] = table[idx[...], :]``, bit-exact.

    ``table``: int32 ``[R, W]``, contiguous, ``W * 4`` a multiple of 16
    bytes; ``idx``: int64 of any shape, contiguous, on ``table``'s device.
    Returns int32 ``[*idx.shape, W]``.

    Contract: every index lies in ``[0, R)``. The kernel neither clamps nor
    checks (a check would read the indices back and stall the decode step);
    the engine's indices are in range by construction (trie node ids from
    trie entries, hashes reduced modulo the table size).
    """
    for name, t in (("table", table), ("idx", idx)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: expected a torch.Tensor, got {type(t).__name__}")
    if table.dtype != torch.int32:
        raise TypeError(f"table: expected torch.int32, got {table.dtype}")
    if idx.dtype != torch.int64:
        raise TypeError(f"idx: expected torch.int64, got {idx.dtype}")
    if table.dim() != 2:
        raise ValueError(f"table: expected [rows, width], got shape {tuple(table.shape)}")
    width = table.shape[1]
    if width == 0 or (width * table.element_size()) % VECTOR_BYTES:
        raise ValueError(
            f"table: row width {width} int32 words is not a multiple of {VECTOR_BYTES} bytes"
        )
    if idx.device != table.device:
        raise ValueError(f"idx: on {idx.device}, expected {table.device}")
    if not table.is_contiguous() or not idx.is_contiguous():
        raise ValueError("table and idx must be contiguous")
    dev = table.device
    if dev.type == "cpu":
        return gather_rows_ref(table, idx)
    _launch_device(dev)
    out = torch.empty((*idx.shape, width), dtype=torch.int32, device=dev)
    if idx.numel() == 0:
        return out
    if table.data_ptr() % VECTOR_BYTES or out.data_ptr() % VECTOR_BYTES:
        raise ValueError(f"table and out must be {VECTOR_BYTES}-byte aligned")
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.gather_rows_launch(
            _ptr(table), _ptr(idx), _ptr(out), idx.numel(),
            width * table.element_size() // VECTOR_BYTES, ctypes.c_void_p(stream),
        )
    _raise_on(err, "gather_rows")
    gather_rows.launches += 1
    return out


gather_rows.launches = 0
