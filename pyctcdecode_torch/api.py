"""Public factory: build a ready-to-use CTC decoder on the PyTorch engine.

Mirrors the reference entry point ``build_ctcdecoder``
(ref ``pyctcdecode/decoder.py:1051-1099``) and the JAX package's
``api.build_ctcdecoder``. The device decoder runs on CUDA unless
``device="cpu"``; ``engine="host"`` returns the host oracle. There is no
automatic choice between the two: an engine picked for want of a device
would hide that the device is missing.
"""
from __future__ import annotations

import logging
from typing import Collection, List, Optional, Union

import torch

from .alphabet import Alphabet, verify_alphabet_coverage
from .constants import (
    DEFAULT_ALPHA,
    DEFAULT_BETA,
    DEFAULT_SCORE_LM_BOUNDARY,
    DEFAULT_UNK_LOGP_OFFSET,
)
from .decoder import BeamSearchDecoderCTC
from .models.language_model import LanguageModel
from .models.ngram import load_unigram_set_from_arpa, open_ngram_file
from .torch_decoder import TorchBeamSearchDecoderCTC
from .utils import profiling

logger = logging.getLogger(__name__)

_ENGINES = ("torch", "host")


def build_ctcdecoder(
    labels: List[str],
    kenlm_model_path: Optional[str] = None,
    unigrams: Optional[Collection[str]] = None,
    alpha: float = DEFAULT_ALPHA,
    beta: float = DEFAULT_BETA,
    unk_score_offset: float = DEFAULT_UNK_LOGP_OFFSET,
    lm_score_boundary: bool = DEFAULT_SCORE_LM_BOUNDARY,
    engine: str = "torch",
    device: Union[None, str, torch.device] = None,
    **engine_options: "object",
) -> Union[TorchBeamSearchDecoderCTC, BeamSearchDecoderCTC]:
    """Build a ready-to-use decoder (main entry point).

    Args:
        labels: raw model labels (logit column order).
        kenlm_model_path: optional path to an n-gram LM: ARPA (``.arpa``,
            ``.arpa.gz``), a KenLM binary (``.bin`` / ``.binary``: PROBING,
            TRIE or QUANT_TRIE) or ``.ctclm``; the kwarg name matches the
            reference API, but the file is loaded by this package's own
            n-gram runtime.
        unigrams: known word vocabulary (inferred from \\1-grams for ARPA,
            from the vocabulary strings of a binary or ``.ctclm`` model).
        alpha: LM weight for shallow fusion.
        beta: per-word length bonus.
        unk_score_offset: log-score offset for OOV words.
        lm_score_boundary: whether the LM scores <s>/</s> boundaries.
        engine: ``"torch"`` for the device engine, ``"host"`` for the
            exact host engine (:class:`~pyctcdecode_torch.decoder.BeamSearchDecoderCTC`).
        device: the device engine's device: ``None`` (CUDA, raising when
            absent) or an explicit device such as ``"cpu"``. The host
            engine takes none.
        **engine_options: forwarded to the device engine's constructor
            (``fast_topk``, ``segment_frames``); rejected with the host
            engine, which has no such knobs.
    """
    if engine not in _ENGINES:
        raise ValueError(f"engine must be one of {_ENGINES}; got {engine!r}")
    if engine == "host" and device is not None:
        raise TypeError("device applies to the torch engine only; the host engine runs on the CPU")
    if engine == "host" and engine_options:
        raise TypeError(
            f"engine options {sorted(engine_options)} apply to the device engine only; "
            "the host engine accepts none (remove them or use engine='torch')"
        )
    with profiling.call("build"):
        profiling.stage("build.read_lm")
        ngram_model = None if kenlm_model_path is None else open_ngram_file(kenlm_model_path)
        if kenlm_model_path is not None and kenlm_model_path.endswith(".arpa"):
            logger.info(
                "loading a plain-text ARPA model; the compiled .ctclm format "
                "loads much faster for repeated use"
            )
        profiling.stage("build.unigrams")
        if unigrams is None and kenlm_model_path is not None:
            if kenlm_model_path.endswith((".arpa", ".arpa.gz")):
                unigrams = load_unigram_set_from_arpa(kenlm_model_path)
            elif hasattr(ngram_model, "vocab_words"):
                # KenLM binaries and .ctclm files carry their vocabulary strings;
                # unlike the reference (whose kenlm binding cannot enumerate
                # them, ref decoder.py:1080-1084) the word set is read directly
                unigrams = [
                    w
                    for w in ngram_model.vocab_words()
                    if not (w.startswith("<") and w.endswith(">"))
                ]
            else:
                logger.warning(
                    "no unigram vocabulary given and none can be read from a "
                    "non-ARPA model file; partial-word scoring will treat every "
                    "prefix as unknown"
                )
        alphabet = Alphabet.build_alphabet(labels)
        if unigrams is not None:
            verify_alphabet_coverage(alphabet, unigrams)
        language_model: Optional[LanguageModel] = None
        if ngram_model is not None:
            profiling.stage("build.language_model")
            language_model = LanguageModel(
                ngram_model,
                unigrams,
                alpha=alpha,
                beta=beta,
                unk_score_offset=unk_score_offset,
                score_boundary=lm_score_boundary,
            )
        if engine == "host":
            return BeamSearchDecoderCTC(alphabet, language_model)
        return TorchBeamSearchDecoderCTC(alphabet, language_model, device=device, **engine_options)
