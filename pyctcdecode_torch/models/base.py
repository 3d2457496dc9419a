"""Abstract language-model interfaces and state containers.

Parity surface: ref ``language_model.py:37-64, 192-227``. States in this
framework are plain word-id tuples under the hood (hashable, picklable,
trivially convertible to device arrays), unlike the reference's opaque C++
``kenlm.State`` objects — but the multiprocessing-safety protocol
(``get_mp_safe_state`` returning ``None``) is preserved so batched outputs
compare equal with the reference's.
"""
from __future__ import annotations

import abc
from typing import Any, Dict, Optional, Sequence, Tuple


class AbstractLMState(abc.ABC):
    """Opaque LM state handle carried between scoring calls."""

    def get_mp_safe_state(self) -> Optional["AbstractLMState"]:
        """Process-boundary-safe version of this state (None by default)."""
        return None


class NGramLMState(AbstractLMState):
    """State of an n-gram LM: the matched context suffix, as word ids."""

    __slots__ = ("_context",)

    def __init__(self, context: Tuple[int, ...]) -> None:
        self._context = tuple(context)

    @property
    def context(self) -> Tuple[int, ...]:
        return self._context

    def __eq__(self, other: Any) -> bool:
        return isinstance(other, NGramLMState) and other._context == self._context

    def __hash__(self) -> int:
        return hash(self._context)

    def __repr__(self) -> str:
        return f"NGramLMState({self._context!r})"


class MultiLMState(AbstractLMState):
    """Tuple of member states for :class:`MultiLanguageModel`."""

    def __init__(self, states: Sequence[AbstractLMState]) -> None:
        self._states = list(states)

    @property
    def states(self) -> Sequence[AbstractLMState]:
        return self._states

    def __eq__(self, other: Any) -> bool:
        return (
            isinstance(other, MultiLMState)
            and list(other.states) == list(self._states)
        )

    def __hash__(self) -> int:
        return hash(tuple(self._states))

    def __repr__(self) -> str:
        return f"MultiLMState({self._states!r})"


class AbstractLanguageModel(abc.ABC):
    """Scoring interface consumed by the decoder engines."""

    @property
    @abc.abstractmethod
    def order(self) -> int:
        """Order of the n-gram model."""
        raise NotImplementedError()

    @abc.abstractmethod
    def get_start_state(self) -> AbstractLMState:
        """Initial LM state."""
        raise NotImplementedError()

    @abc.abstractmethod
    def score_partial_token(self, partial_token: str) -> float:
        """Score (natural-log domain contribution) for an in-progress word."""
        raise NotImplementedError()

    @abc.abstractmethod
    def score(
        self, prev_state: AbstractLMState, word: str, is_last_word: bool = False
    ) -> Tuple[float, AbstractLMState]:
        """Fused score of ``word`` given ``prev_state``, plus the new state."""
        raise NotImplementedError()

    def save_to_dir(self, filepath: str) -> None:
        """Save model to a directory (optional capability)."""
        raise NotImplementedError()

    @classmethod
    def load_from_dir(cls, filepath: str) -> "AbstractLanguageModel":
        """Load model from a directory (optional capability)."""
        raise NotImplementedError()

    def reset_params(self, **params: Dict[str, Any]) -> None:
        """Re-tune simple scoring parameters in place (optional)."""
