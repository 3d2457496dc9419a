"""chunk_prep_ms.stream: The median, over the measured window's chunks, of the host's preparation
and upload of a chunk: the program's ``chunk.prep`` and ``chunk.upload`` spans.
"""
from cardbench.harness.program import median_ms


def read(rec):
    if rec["kind"] != "stream":
        return None
    return median_ms(rec, "chunk", ("chunk.prep", "chunk.upload"))
