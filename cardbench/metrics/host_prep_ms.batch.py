"""host_prep_ms.batch: The median, over the measured window's batch calls, of the host's
preparation and upload: the program's ``batch.prep`` and ``batch.upload`` spans in a call.
"""
from cardbench.harness.program import median_ms


def read(rec):
    if rec["kind"] != "batch":
        return None
    return median_ms(rec, "batch", ("batch.prep", "batch.upload"))
