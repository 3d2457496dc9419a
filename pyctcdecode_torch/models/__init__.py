"""Language models: the ARPA n-gram runtime, fusion wrappers, hotwords and device tables."""
from .base import AbstractLanguageModel, AbstractLMState, MultiLMState, NGramLMState
from .hotwords import HotwordScorer
from .language_model import LanguageModel, MultiLanguageModel
from .ngram import NGramModel, load_unigram_set_from_arpa, open_ngram_file, read_arpa

__all__ = [
    "AbstractLanguageModel",
    "AbstractLMState",
    "HotwordScorer",
    "LanguageModel",
    "MultiLMState",
    "MultiLanguageModel",
    "NGramLMState",
    "NGramModel",
    "load_unigram_set_from_arpa",
    "open_ngram_file",
    "read_arpa",
]
