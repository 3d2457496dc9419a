"""chunk_device_ms.stream: Device busy ms of the traced stretch of the stream
loop, per chunk served in it.
"""
def read(rec):
    t, n = rec["trace"], rec.get("traced", {}).get("chunks")
    if rec["kind"] != "stream" or not t or not n or t["busy_s"] <= 0:
        return None
    return t["busy_s"] * 1e3 / n
