"""Default decoding hyperparameters.

These knobs define behavioral parity with the reference implementation
(kensho-technologies/pyctcdecode, ``pyctcdecode/constants.py:1-18``): identical
defaults are required so that decodes at default settings produce identical
output. Everything here is a plain Python constant.
"""
import math

# Shallow-fusion weights.
DEFAULT_ALPHA = 0.5  # LM weight
DEFAULT_BETA = 1.5  # per-word length bonus

# Score offset applied (in the LM's log10 domain, pre-alpha) to OOV words.
DEFAULT_UNK_LOGP_OFFSET = -10.0

DEFAULT_BEAM_WIDTH = 100
DEFAULT_HOTWORD_WEIGHT = 10.0

# Beams whose fused score falls more than this (natural log) below the best
# beam are dropped each frame.
DEFAULT_PRUNE_LOGP = -10.0
DEFAULT_PRUNE_BEAMS = False  # history pruning off by default

# Tokens with frame log-prob below this are not expanded (argmax always is).
DEFAULT_MIN_TOKEN_LOGP = -5.0

# Whether the LM scores <s>/<\s> sentence boundaries.
DEFAULT_SCORE_LM_BOUNDARY = True

# Expected average word length; partial words longer than this get their
# UNK penalty scaled up proportionally.
AVG_TOKEN_LEN = 6

# Probability floor applied when converting inputs to log-probs.
MIN_TOKEN_CLIP_P = 1e-15

# n-gram LMs store log10 probabilities; decoding works in natural log.
LOG_BASE_CHANGE_FACTOR = 1.0 / math.log10(math.e)
