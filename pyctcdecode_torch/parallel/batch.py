"""Data-parallel batch decoding over a ``torch.distributed`` process group.

The reference's whole distribution story is a fork-only
``multiprocessing.Pool`` mapping utterances to processes, with the LM shared
by copy-on-write (ref ``decoder.py:146-157, 777-945``). The JAX reference
package shards the utterance batch over a device mesh under one controller.
Here one process drives one device (SPMD): every process of the group
passes the same global batch, prepares it on the host as a single decoder
would (normalization, blank collapse, token timeline, the ``"auto"`` K and
the step count are the whole batch's), decodes its block of rows ``[rank *
per, (rank + 1) * per)`` (``per = ceil(n / processes)``; the batch pads to
``per * processes`` rows with empty utterances), and the results are
exchanged with ``all_gather_object``.

Per-utterance decoding is independent and deterministic, so the sharded
result is element-wise identical to the single decoder's.

``shard_lm=True`` also row-shards every n-gram bucket plane over the group
(:class:`~pyctcdecode_torch.models.device_tables.LMShard`): each process
holds ``1 / processes`` of the tables, and every probe of a step or a
finalize becomes one collective round trip
(:func:`~pyctcdecode_torch.models.device_tables.probe_rows_sharded`). Every
process runs the same steps (the global batch's longest row), so the
collectives line up. Sharded or not, each process decodes its rows as the
wrapped decoder does: in segments of its ``segment_frames`` (16 on the
card), each one replay of a captured CUDA graph, with the key's finalize
graph after them. With ``shard_lm`` the probes' NCCL ``all_gather`` and
``all_reduce`` are captured inside those graphs, and every replay issues
them; every process's cache sees the same keys in the same order (see
``TorchBeamSearchDecoderCTC._segment_graph``). A wrapped decoder made with
``with_options(segment_frames=0)`` runs the eager frame loop instead, and
so does the CPU (gloo), where nothing is captured.
"""
from __future__ import annotations

import logging
import os
from typing import Any, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..constants import (
    DEFAULT_BEAM_WIDTH,
    DEFAULT_HOTWORD_WEIGHT,
    DEFAULT_MIN_TOKEN_LOGP,
    DEFAULT_PRUNE_BEAMS,
    DEFAULT_PRUNE_LOGP,
)
from ..engine import build_table_args
from ..models.device_tables import LMShard
from .launch import backend_for, initialize_from_env

logger = logging.getLogger(__name__)

_TORCH_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def make_data_mesh(n_devices: Optional[int] = None, axis: str = "data",
                   device: Union[None, str, torch.device] = None) -> "object":
    """A 1-D ``DeviceMesh`` over the processes of the ``torch.distributed`` group.

    Brings the process group up first where it is not: from the ``PYCTC_*``
    variables (:func:`~.launch.initialize_from_env`) or ``torch.distributed``'s
    own (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``). With
    neither it raises: a sharded decode never quietly runs in one process.
    ``device`` picks the backend (NCCL for CUDA, the default; gloo for the
    CPU). ``n_devices``, where given, must be the process count (one
    device a process).
    """
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized() and not initialize_from_env(device=device):
        if not all(key in os.environ for key in _TORCH_ENV):
            raise RuntimeError(
                "no torch.distributed process group: call "
                "torch.distributed.init_process_group, or set PYCTC_COORDINATOR / "
                "PYCTC_NUM_PROCESSES / PYCTC_PROCESS_ID or MASTER_ADDR / MASTER_PORT / "
                "WORLD_SIZE / RANK"
            )
        backend = backend_for(device)
        if backend == "nccl":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", os.environ["RANK"])) % torch.cuda.device_count())
        dist.init_process_group(backend, init_method="env://")
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"n_devices={n_devices}: one device a process, and the group has {world}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (world,), mesh_dim_names=(axis,))


def all_reduce_counts(mesh: "object", per_shard_counts: np.ndarray, axis: str = "data") -> np.ndarray:
    """Sum integer counters (e.g. WER edits and reference words) over the mesh's processes.

    ``per_shard_counts``: this process's counters, ``[m]`` or ``[1, m]``
    (the JAX reference takes ``[n_devices, m]`` in one controller; here each
    process holds its own row). Returns the ``[m]`` global sums on every
    process: one ``all_reduce``.
    """
    import torch.distributed as dist

    arr = np.asarray(per_shard_counts, dtype=np.int64)
    if arr.ndim == 2 and arr.shape[0] == 1:
        arr = arr[0]
    if arr.ndim != 1:
        raise ValueError(f"per_shard_counts must be this process's [m] (or [1, m]) counters; got {arr.shape}")
    dev = torch.device("cuda", torch.cuda.current_device()) if mesh.device_type == "cuda" else torch.device("cpu")
    counts = torch.as_tensor(arr, device=dev)
    dist.all_reduce(counts, group=mesh.get_group(axis))
    return counts.cpu().numpy()


class ShardedCTCDecoder:
    """Batch CTC decoding split over the processes of a mesh (data parallelism).

    Wraps a :class:`~pyctcdecode_torch.torch_decoder.TorchBeamSearchDecoderCTC`
    built on this process's device; ``mesh`` defaults to
    :func:`make_data_mesh` on that device's backend. ``shard_lm=True`` also
    row-shards the n-gram tables over the mesh axis: each process holds
    ``1 / processes`` of every bucket plane and probes through collectives.
    Decodes are element-wise identical to the replicated layout and to the
    single decoder, and run as the wrapped decoder's do: as captured graphs
    on the card, collectives included; pass a decoder made with
    ``with_options(segment_frames=0)`` for the eager frame loop.
    """

    def __init__(self, decoder: "object", mesh: "object" = None, axis: str = "data",
                 shard_lm: bool = False) -> None:
        import torch.distributed as dist

        self._decoder = decoder
        self._mesh = mesh if mesh is not None else make_data_mesh(axis=axis, device=decoder.device)
        self._axis = axis
        self._group = self._mesh.get_group(axis)
        self._rank = dist.get_rank(self._group)
        self._world = dist.get_world_size(self._group)
        if shard_lm and decoder._device_lm:
            self._tabs = build_table_args(
                decoder._tokens, decoder._device_lm, decoder.device,
                shard=LMShard(self._group, self._rank, self._world),
            )
        else:
            self._tabs = decoder._tabs

    @property
    def mesh(self) -> "object":
        return self._mesh

    @property
    def n_devices(self) -> int:
        return self._world

    def _rows(self, n: int) -> Tuple[int, int]:
        """This process's block of the padded batch: ``(first row, rows per process)``."""
        per = -(-n // self._world)
        return self._rank * per, per

    def _decode_local(self, logits_list: Sequence[np.ndarray], collect_stats: bool, **kw: Any):
        """Launch and collect this process's rows of the global batch: ``(results, stats)``.

        The wrapped decoder runs them, with its ``segment_frames`` and its
        graph cache; a ``shard_lm`` decode's keys differ from the replicated
        ones by its tables (``self._tabs``).
        """
        handle = self._decoder._dispatch_batch(
            list(logits_list), batch_pad=self._world, row_block=self._rows(len(logits_list)),
            tabs=self._tabs, collect_stats=collect_stats, **kw,
        )
        return self._decoder._collect_batch(handle, with_stats=True)

    def decode_beams_batch(
        self,
        logits_list: Sequence[np.ndarray],
        beam_width: int = DEFAULT_BEAM_WIDTH,
        beam_prune_logp: float = DEFAULT_PRUNE_LOGP,
        token_min_logp: float = DEFAULT_MIN_TOKEN_LOGP,
        prune_history: bool = DEFAULT_PRUNE_BEAMS,
        hotwords: "object" = None,
        hotword_weight: float = DEFAULT_HOTWORD_WEIGHT,
        max_tokens_per_frame: Optional[Union[int, str]] = None,
        top_n: Optional[int] = None,
        collect_stats: bool = False,
        blank_collapse: bool = False,
        token_chunking: Union[None, bool, int] = None,
    ) -> "object":
        """Decode a global batch split over the processes; every process returns the whole result.

        Every process passes the same ``logits_list``. With
        ``collect_stats=True`` returns ``(results, stats)``, one counter dict
        per utterance (as
        :meth:`~pyctcdecode_torch.torch_decoder.TorchBeamSearchDecoderCTC.decode_beams_batch`).
        ``token_chunking`` and ``blank_collapse`` as on the single decoder.
        """
        import torch.distributed as dist

        if not logits_list:
            return []
        local = self._decode_local(
            logits_list, collect_stats, beam_width=beam_width, beam_prune_logp=beam_prune_logp,
            token_min_logp=token_min_logp, prune_history=prune_history, hotwords=hotwords,
            hotword_weight=hotword_weight, max_tokens_per_frame=max_tokens_per_frame, top_n=top_n,
            blank_collapse=blank_collapse, token_chunking=token_chunking,
        )
        parts: List[Any] = [None] * self._world
        dist.all_gather_object(parts, local, group=self._group)
        results = [beams for part_results, _ in parts for beams in part_results]
        if collect_stats:
            return results, [st for _, part_stats in parts for st in part_stats]
        return results

    def decode_beams_batch_multiprocess(
        self,
        global_logits_list: Sequence[np.ndarray],
        beam_width: int = DEFAULT_BEAM_WIDTH,
        beam_prune_logp: float = DEFAULT_PRUNE_LOGP,
        token_min_logp: float = DEFAULT_MIN_TOKEN_LOGP,
        prune_history: bool = DEFAULT_PRUNE_BEAMS,
        max_tokens_per_frame: Optional[Union[int, str]] = None,
        top_n: Optional[int] = None,
    ) -> "object":
        """SPMD decode with no output exchange: this process's results and ``(start, stop)``.

        Every process passes the same ``global_logits_list``; ``results`` are
        the beam lists of ``global_logits_list[start:stop]``, this process's
        block (:func:`~.launch.process_shard`). Gathering them is the
        caller's job.
        """
        if not global_logits_list:
            return [], (0, 0)
        results, _ = self._decode_local(
            global_logits_list, False, beam_width=beam_width, beam_prune_logp=beam_prune_logp,
            token_min_logp=token_min_logp, prune_history=prune_history, hotwords=None,
            hotword_weight=DEFAULT_HOTWORD_WEIGHT, max_tokens_per_frame=max_tokens_per_frame, top_n=top_n,
        )
        first, per = self._rows(len(global_logits_list))
        start = min(first, len(global_logits_list))
        return results, (start, min(first + per, len(global_logits_list)))

    def decode_batch(
        self,
        logits_list: Sequence[np.ndarray],
        beam_width: int = DEFAULT_BEAM_WIDTH,
        beam_prune_logp: float = DEFAULT_PRUNE_LOGP,
        token_min_logp: float = DEFAULT_MIN_TOKEN_LOGP,
        hotwords: "object" = None,
        hotword_weight: float = DEFAULT_HOTWORD_WEIGHT,
        max_tokens_per_frame: Optional[Union[int, str]] = None,
    ) -> List[str]:
        """Sharded batch top-1 transcripts."""
        beams = self.decode_beams_batch(
            logits_list,
            beam_width=beam_width,
            beam_prune_logp=beam_prune_logp,
            token_min_logp=token_min_logp,
            prune_history=True,
            hotwords=hotwords,
            hotword_weight=hotword_weight,
            max_tokens_per_frame=max_tokens_per_frame,
            top_n=1,
        )
        return [b[0].text if b else "" for b in beams]
