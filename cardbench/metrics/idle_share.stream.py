"""idle_share.stream: The device's idle share of the measured window of the stream loop: 1 - the
traced chunks' device busy time a chunk, times the chunks the window served, over the window.

The profiler slows the host while it traces, so the traced stretch's own
wall time would overstate the idle share; the device busy time a chunk is
read from the trace.
"""
def read(rec):
    t, w, n = rec["trace"], rec.get("window"), rec.get("traced", {}).get("chunks")
    if rec["kind"] != "stream" or not t or not n or t["busy_s"] <= 0 or not w or not w.get("chunks"):
        return None
    return 1.0 - (t["busy_s"] / n) * w["chunks"] / (w["end"] - w["start"])
