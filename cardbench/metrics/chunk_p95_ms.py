"""chunk_p95_ms: The 95th percentile, over every chunk due in the measured
window, of due time to return.
"""
from cardbench.harness.loops import percentile


def read(rec):
    if rec["kind"] != "stream":
        return None
    return percentile(rec["latency_ms"], 95)
