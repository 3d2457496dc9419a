"""pyctcdecode_torch — CTC beam-search decoding with n-gram LM fusion on PyTorch/CUDA.

The PyTorch port of the JAX/TPU package beside it: the same public
surface (``build_ctcdecoder`` and ``decode`` / ``decode_beams`` /
``decode_batch`` / ``decode_beams_batch``, streaming through
``get_starting_state`` / ``partial_decode_beams``, hotwords, a
``MultiLanguageModel`` of n-gram members), a batched device engine written
in PyTorch, hand-written CUDA kernels for the candidate merge and the LM
table reads, and the host oracle ``BeamSearchDecoderCTC``. Entry points run
on CUDA unless the caller passes ``device="cpu"``.
"""
from .alphabet import Alphabet
from .api import build_ctcdecoder
from .decoder import Beam, BeamSearchDecoderCTC, LMBeam, OutputBeam
from .models import (
    AbstractLanguageModel,
    AbstractLMState,
    HotwordScorer,
    LanguageModel,
    MultiLanguageModel,
    MultiLMState,
    NGramModel,
)
from .torch_decoder import TorchBeamSearchDecoderCTC

__version__ = "0.1.0"

__all__ = [
    "AbstractLMState",
    "AbstractLanguageModel",
    "Alphabet",
    "Beam",
    "BeamSearchDecoderCTC",
    "HotwordScorer",
    "LMBeam",
    "LanguageModel",
    "MultiLMState",
    "MultiLanguageModel",
    "NGramModel",
    "OutputBeam",
    "TorchBeamSearchDecoderCTC",
    "build_ctcdecoder",
]
