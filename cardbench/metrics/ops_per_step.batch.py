"""ops_per_step.batch: Device rows (kernels, memsets, copies) of the traced
batch calls per step their inputs need.
"""
def read(rec):
    t, n = rec["trace"], rec.get("traced", {}).get("steps")
    if rec["kind"] != "batch" or not t or not n or not t["device_rows"]:
        return None
    return t["device_rows"] / n
