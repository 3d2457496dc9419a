"""lm_build_s: Host seconds of the one ``build_ctcdecoder`` call in set-up."""
def read(rec):
    return rec["lm_build_s"]
