"""chunk_replay_ms.stream: The median, over the measured window's chunks, of the host's backtrace
over the chunks since the last commit and its replay into ``LMBeam``s: the program's
``chunk.backtrace`` and ``chunk.replay`` spans.
"""
from cardbench.harness.program import median_ms


def read(rec):
    if rec["kind"] != "stream":
        return None
    return median_ms(rec, "chunk", ("chunk.backtrace", "chunk.replay"))
