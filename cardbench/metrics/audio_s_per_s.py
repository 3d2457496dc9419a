"""audio_s_per_s: All audio the batch calls of the measured window decoded,
over the window's wall time up to the last return.
"""
def read(rec):
    if rec["kind"] != "batch":
        return None
    w = rec["window"]
    return w["audio_s"] / (w["end"] - w["start"])
