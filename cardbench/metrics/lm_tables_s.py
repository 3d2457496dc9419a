"""lm_tables_s: Host seconds of the set-up's ``build_ctcdecoder`` building the LM's tables: the
program's ``build.language_model`` (the host LM and its word trie) and ``build.device_lm`` (the
token arrays and the device tables, built on the host) spans.
"""
from cardbench.harness.program import setup_seconds


def read(rec):
    return setup_seconds(rec, ("build.language_model", "build.device_lm"))
