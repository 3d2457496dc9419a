"""host_replay_ms.batch: The median, over the measured window's batch calls, of the host's
replay of the fetched token paths into ``OutputBeam`` lists: the program's ``batch.replay`` span.
"""
from cardbench.harness.program import median_ms


def read(rec):
    if rec["kind"] != "batch":
        return None
    return median_ms(rec, "batch", ("batch.replay",))
