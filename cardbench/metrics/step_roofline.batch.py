"""step_roofline.batch: The least time the traced calls' active utterance-steps
need at the chip's peaks (``harness.work``), as a share of their device busy
time, in %.
"""
from cardbench.harness.work import least_seconds


def read(rec):
    t, traced = rec["trace"], rec.get("traced", {})
    if rec["kind"] != "batch" or not t or not traced.get("row_steps") or t["busy_s"] <= 0:
        return None
    return 100.0 * least_seconds(traced["row_steps"], **rec["shape"]) / t["busy_s"]
