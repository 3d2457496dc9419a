"""The batch decode's device backtrace: a CUDA kernel and its plain twin.

``paths[n, r, t]`` for ``t = T-1 .. 0``: ``paths = trace[n, t, cur]``, then
``cur = parents[n, t, cur]``, starting at ``cur = src[n, r]``: each ranked
beam's token at every step of the decode, read back through the
backpointer logs. The JAX reference computes it with a ``lax.scan(back,
..., reverse=True)`` inside its compiled finalize program (``fin_fn`` of its
``make_segment_decode_fns``); no Pallas kernel of the reference does. In
the port the finalize is a captured CUDA graph of one shape, while the logs'
length changes with every batch, so the backtrace is one launch of
:func:`backtrace_paths` after the finalize's replay, where the plain
version issues four small kernels a step.

What bounds it on the H100: by the roofline, bytes (the logs read once, the
paths written once); in fact the chain's latency, one dependent read a
step. The kernel (``csrc/backtrace.cu``) runs one block per utterance and
one thread per chain, and stages tiles of both logs and of the paths in
shared memory, so a chain pays one memory latency a tile, not a step.

Values are copied as they are (-1 at padded frames, the timeline's -3 carry
marker). On CPU tensors :func:`backtrace_paths` runs
:func:`backtrace_paths_ref`; on CUDA tensors it launches the kernel or
raises. ``backtrace_paths.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .merge import _check, _launch, _launch_device, _ptr

LOG_DTYPES = (torch.int8, torch.int16, torch.int32)  # the engine's parent and path dtypes


def backtrace_paths_ref(parents: torch.Tensor, trace: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`backtrace_paths` (any device): a loop over the steps."""
    n, t_max, _ = trace.shape
    cur = src
    paths = torch.empty((n, src.shape[1], t_max), dtype=trace.dtype, device=trace.device)
    for t in range(t_max - 1, -1, -1):
        paths[:, :, t] = trace[:, t].gather(1, cur)
        cur = parents[:, t].gather(1, cur).to(torch.int64)
    return paths


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    """Build (first use) and load ``csrc/backtrace.cu``; declare its C signature."""
    from ..csrc.build import load

    lib = load("backtrace.cu")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.backtrace_paths_launch.argtypes = [vp] * 4 + [ci] * 6 + [vp]
    lib.backtrace_paths_launch.restype = ci
    return lib


def backtrace_paths(parents: torch.Tensor, trace: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """Token paths ``[N, R, T]`` of the ranked beams ``src``, bit-exact.

    ``parents``: int8/int16/int32 ``[N, T, B]``, each entry in ``[0, B)``;
    ``trace``: int8/int16/int32 ``[N, T, B]``; ``src``: int64 ``[N, R]``
    (``R <= B``), each entry in ``[0, B)``. Returns ``trace``'s dtype. The
    kernel does not check the indices (the engine's are in range by
    construction).
    """
    n, t_max, b = trace.shape
    dev = trace.device
    if parents.dtype not in LOG_DTYPES or trace.dtype not in LOG_DTYPES:
        raise TypeError(f"parents / trace: expected one of {LOG_DTYPES}, got {parents.dtype}, {trace.dtype}")
    _check("parents", parents, parents.dtype, (n, t_max, b), dev)
    _check("trace", trace, trace.dtype, (n, t_max, b), dev)
    if src.dim() != 2 or src.shape[0] != n or src.shape[1] > b:
        raise ValueError(f"src: expected [{n}, R <= {b}], got shape {tuple(src.shape)}")
    _check("src", src, torch.int64, None, dev)
    if dev.type == "cpu":
        return backtrace_paths_ref(parents, trace, src)
    _launch_device(dev)
    r = src.shape[1]
    paths = torch.empty((n, r, t_max), dtype=trace.dtype, device=dev)
    if n == 0 or r == 0 or t_max == 0:
        return paths
    _launch(
        "backtrace_paths", dev, _library().backtrace_paths_launch,
        _ptr(parents), _ptr(trace), _ptr(src), _ptr(paths),
        n, t_max, b, r, parents.element_size(), trace.element_size(),
    )
    backtrace_paths.launches += 1
    return paths


backtrace_paths.launches = 0
