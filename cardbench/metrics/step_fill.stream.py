"""step_fill.stream: The measured window's frame steps the chunks need over the steps the device
ran (a chunk padded to whole segments): the program's ``steps.active`` over ``steps.launched``.
"""
from cardbench.harness.program import fill


def read(rec):
    return fill(rec, "stream")
