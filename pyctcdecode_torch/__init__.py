"""pyctcdecode_torch — CTC beam-search decoding with n-gram LM fusion on PyTorch/CUDA.

The PyTorch port of the JAX/TPU package beside it: the same public
surface (``build_ctcdecoder`` and ``decode`` / ``decode_beams`` /
``decode_batch`` / ``decode_beams_batch``, hotwords, a
``MultiLanguageModel`` of n-gram members), a batched device engine written
in PyTorch, and hand-written CUDA kernels for the candidate merge and the LM
table reads. Entry points run on CUDA unless the caller passes
``device="cpu"``.
"""
from .alphabet import Alphabet
from .api import build_ctcdecoder
from .models.base import MultiLMState
from .models.hotwords import HotwordScorer
from .models.language_model import LanguageModel, MultiLanguageModel
from .torch_decoder import TorchBeamSearchDecoderCTC

__version__ = "0.1.0"

__all__ = [
    "Alphabet",
    "HotwordScorer",
    "LanguageModel",
    "MultiLMState",
    "MultiLanguageModel",
    "TorchBeamSearchDecoderCTC",
    "build_ctcdecoder",
]
