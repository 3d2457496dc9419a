"""Language models: the ARPA n-gram runtime, its fusion wrapper and device tables."""
from .base import AbstractLanguageModel, AbstractLMState, NGramLMState
from .language_model import LanguageModel
from .ngram import NGramModel, open_ngram_file

__all__ = [
    "AbstractLanguageModel",
    "AbstractLMState",
    "LanguageModel",
    "NGramLMState",
    "NGramModel",
    "open_ngram_file",
]
