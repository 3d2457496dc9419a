"""lm_read_s: Host seconds of the set-up's ``build_ctcdecoder`` reading the LM file: the program's
``build.read_lm`` (the n-gram read) and ``build.unigrams`` (the word list, read again) spans.
"""
from cardbench.harness.program import setup_seconds


def read(rec):
    return setup_seconds(rec, ("build.read_lm", "build.unigrams"))
