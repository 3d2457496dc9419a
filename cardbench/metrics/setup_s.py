"""setup_s: Process start to the first timed call: imports, the decoder's
build, the traffic, the warm-up.
"""
def read(rec):
    return rec["setup_s"]
