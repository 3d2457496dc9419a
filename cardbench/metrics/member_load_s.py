"""member_load_s: Host seconds of the set-up reading and building an ensemble's members, summed over them:
the program's root spans ``lm.read`` (``open_ngram_file``), ``lm.unigrams``
(``load_unigram_set_from_arpa``) and ``lm.language_model`` (``LanguageModel``, its word trie).

A caller that builds a ``MultiLanguageModel`` loads each member outside
``build_ctcdecoder``, so each site is a root of its own; inside
``build_ctcdecoder``'s ``build`` root they open nothing, and ``lm_read_s`` /
``lm_tables_s`` read that build. None where the set-up holds no such root
(a run with the tracer off, or a program without these spans).
"""
ROOTS = ("lm.read", "lm.unigrams", "lm.language_model")


def read(rec):
    setup = (rec.get("program") or {}).get("setup")
    if not setup:
        return None
    spans = [s for s in setup["spans"] if s["parent"] < 0 and s["name"] in ROOTS]
    return sum(s["end"] - s["start"] for s in spans) if spans else None
