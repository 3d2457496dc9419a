"""Language models: the n-gram runtimes (ARPA, .ctclm, KenLM binaries), fusion wrappers, hotwords and device tables."""
from .base import AbstractLanguageModel, AbstractLMState, MultiLMState, NGramLMState
from .hotwords import HotwordScorer
from .kenlm_bin import KenLMBinaryModel
from .language_model import LanguageModel, MultiLanguageModel
from .ngram import NGramModel, load_unigram_set_from_arpa, open_ngram_file, read_arpa

__all__ = [
    "AbstractLanguageModel",
    "AbstractLMState",
    "HotwordScorer",
    "KenLMBinaryModel",
    "LanguageModel",
    "MultiLMState",
    "MultiLanguageModel",
    "NGramLMState",
    "NGramModel",
    "load_unigram_set_from_arpa",
    "open_ngram_file",
    "read_arpa",
]
