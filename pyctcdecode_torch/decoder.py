"""Beam and output records shared by the decoders.

Parity surface: ref ``decoder.py:50-115`` (``LMBeam``, ``OutputBeam``). The
host beam-search oracle of the JAX reference package is not ported yet; this
module holds only the records and helpers the device decoder returns.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from .models.base import AbstractLMState

# frame span of one word: (start_frame, end_frame)
Frames = Tuple[int, int]
WordFrames = Tuple[str, Frames]

NULL_FRAMES: Frames = (-1, -1)


@dataclasses.dataclass(frozen=True, slots=True)
class LMBeam:
    """Beam plus its fused (logit + LM + hotword) score.

    Field order mirrors the reference's ``LMBeam`` so positional construction
    stays drop-in compatible; the per-beam BPE break flag rides at the end.
    """

    text: str
    next_word: str
    partial_word: str
    last_char: Optional[str]
    text_frames: List[Frames]
    partial_frames: Frames
    logit_score: float
    lm_score: float = 0.0
    force_next_break: bool = False


@dataclasses.dataclass(frozen=True, slots=True)
class OutputBeam:
    """Final decoded hypothesis."""

    text: str
    last_lm_state: Optional[AbstractLMState]
    text_frames: List[WordFrames]
    logit_score: float  # cumulative acoustic log score
    lm_score: float  # cumulative fused score

    def get_mp_safe_beam(self) -> "OutputBeam":
        """Version of this beam safe to send across process boundaries."""
        if self.last_lm_state is None:
            last_lm_state = None
        else:
            last_lm_state = self.last_lm_state.get_mp_safe_state()
        return dataclasses.replace(self, last_lm_state=last_lm_state)


def collapse_spaces(text: str) -> str:
    """Squeeze whitespace runs to single spaces and strip the ends."""
    return " ".join(text.split())
