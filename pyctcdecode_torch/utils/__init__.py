"""Host utilities (input normalization, metrics, the prefix trie) and the torch normalization."""
from .logits import log_softmax_np, normalize_to_logp, normalize_to_logp_torch
from .metrics import character_error_rate, edit_distance, word_error_rate
from .trie import CharTrie

__all__ = [
    "CharTrie",
    "character_error_rate",
    "edit_distance",
    "log_softmax_np",
    "normalize_to_logp",
    "normalize_to_logp_torch",
    "word_error_rate",
]
