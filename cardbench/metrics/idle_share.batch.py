"""idle_share.batch: The device's idle share of an untraced batch call: 1 - the traced calls'
device busy time a call over the measured window's wall time a call.

The profiler slows the host while it traces, so the traced calls' own wall
time would overstate the idle share; their device busy time a call is set by
the shapes and is read from the trace.
"""
def read(rec):
    t, w, n = rec["trace"], rec.get("window"), rec.get("traced", {}).get("calls")
    if rec["kind"] != "batch" or not t or not n or t["busy_s"] <= 0 or not w or not w.get("calls"):
        return None
    return 1.0 - (t["busy_s"] / n) / ((w["end"] - w["start"]) / w["calls"])
