"""Multi-process bring-up for sharded decoding over ``torch.distributed``.

The reference scales across machines by running independent Python
processes, each with its own fork pool and a copy-on-write LM (ref
``decoder.py:777-945``), with no coordination at all. Here one process
drives one device, and the processes of a decode form one
``torch.distributed`` process group: every process calls
:func:`initialize_from_env` (or ``init_process_group`` itself), after which
:class:`~pyctcdecode_torch.parallel.batch.ShardedCTCDecoder` splits the
utterance batch, and optionally the LM's n-gram tables, across the group,
with NCCL collectives between the cards (gloo on the CPU).

Launcher contract (the JAX reference package's variables):

* ``PYCTC_COORDINATOR``: ``host:port`` of process 0 (required when any of
  these variables is set);
* ``PYCTC_NUM_PROCESSES``: the process count;
* ``PYCTC_PROCESS_ID``: this process's rank in ``[0, num_processes)``.

A launcher that sets ``torch.distributed``'s own variables (``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, as ``torchrun`` does) needs none
of these: :func:`~pyctcdecode_torch.parallel.batch.make_data_mesh` reads
them.
"""
from __future__ import annotations

import logging
import os
from typing import Optional, Sequence, Tuple, Union

import torch

logger = logging.getLogger(__name__)

_ENV_COORD = "PYCTC_COORDINATOR"
_ENV_NPROC = "PYCTC_NUM_PROCESSES"
_ENV_PID = "PYCTC_PROCESS_ID"


def backend_for(device: Union[None, str, torch.device]) -> str:
    """The collective backend of a process that decodes on ``device``: NCCL on CUDA, gloo on the CPU.

    ``None`` means CUDA, and raises where there is none (nothing falls back
    to the CPU on its own).
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "sharded decoding runs on CUDA by default and no CUDA device is "
                "available; pass device='cpu' for gloo on the CPU"
            )
        return "nccl"
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize_from_env(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: Union[None, str, torch.device] = None,
) -> bool:
    """Initialize the ``torch.distributed`` process group from arguments or ``PYCTC_*`` variables.

    Returns ``True`` when a process group was brought up, ``False`` when no
    configuration is present (a single process: not an error, so a program
    can call this unconditionally at start). ``device`` picks the backend
    (:func:`backend_for`); with NCCL each process takes the card
    ``process_id % device_count``.
    """
    import torch.distributed as dist

    coordinator = coordinator or os.environ.get(_ENV_COORD)
    if num_processes is None and _ENV_NPROC in os.environ:
        num_processes = int(os.environ[_ENV_NPROC])
    if process_id is None and _ENV_PID in os.environ:
        process_id = int(os.environ[_ENV_PID])
    if coordinator is None and num_processes is None and process_id is None:
        return False
    if coordinator is None or num_processes is None or process_id is None:
        raise ValueError(
            "incomplete multi-process configuration: need all three of "
            f"{_ENV_COORD}, {_ENV_NPROC}, {_ENV_PID} (or the matching "
            "arguments), got "
            f"coordinator={coordinator!r} num_processes={num_processes!r} "
            f"process_id={process_id!r}"
        )
    backend = backend_for(device)
    if backend == "nccl":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator}", world_size=num_processes, rank=process_id
    )
    logger.info("process group up (%s): process %d of %d", backend, process_id, num_processes)
    return True


def _world() -> Tuple[int, int]:
    """(rank, process count): (0, 1) without a process group."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def process_shard(n_items: int) -> Tuple[int, int]:
    """This process's ``[start, stop)`` slice of a global batch of ``n_items``.

    Contiguous blocks of ``ceil(n_items / processes)`` in rank order, the
    rows :class:`~pyctcdecode_torch.parallel.batch.ShardedCTCDecoder`
    decodes on this process; the last blocks may be short or empty.
    """
    rank, nproc = _world()
    per = (n_items + nproc - 1) // nproc
    start = min(rank * per, n_items)
    return start, min(start + per, n_items)


def local_batch(global_batch: Sequence, pad_to_multiple: bool = True) -> "object":
    """Slice a host-resident global batch down to this process's shard.

    Every process must pass the same ``global_batch`` ordering. With
    ``pad_to_multiple`` the slice is padded by repeating its last element
    so all processes hold equal-size shards; callers drop the padded tail
    by counting ``min(len(shard), stop - start)`` real items.
    """
    start, stop = process_shard(len(global_batch))
    shard = list(global_batch[start:stop])
    if pad_to_multiple:
        _, nproc = _world()
        per = (len(global_batch) + nproc - 1) // nproc
        while len(shard) < per and shard:
            shard.append(shard[-1])
        if not shard and len(global_batch):
            shard = [global_batch[0]] * per
    return shard
