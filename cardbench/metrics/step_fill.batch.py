"""step_fill.batch: The measured window's row-steps the batch inputs need over the row-steps the
device ran (padded rows, steps padded to whole segments): the program's ``steps.active`` over
``steps.launched``.
"""
from cardbench.harness.program import fill


def read(rec):
    return fill(rec, "batch")
