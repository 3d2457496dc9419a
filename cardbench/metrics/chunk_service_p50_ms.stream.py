"""chunk_service_p50_ms.stream: The median chunk call, from its start to its
return (no queueing), over the measured window.
"""
from cardbench.harness.loops import percentile


def read(rec):
    if rec["kind"] != "stream":
        return None
    return percentile(rec["service_ms"], 50)
