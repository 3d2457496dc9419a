"""step_device_ms.batch: Device busy ms of the traced batch calls over the
steps their inputs need (each call's longest utterance).
"""
def read(rec):
    t, n = rec["trace"], rec.get("traced", {}).get("steps")
    if rec["kind"] != "batch" or not t or not n or t["busy_s"] <= 0:
        return None
    return t["busy_s"] * 1e3 / n
