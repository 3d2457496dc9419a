"""sentence_beams.batch: The share of the measured window's returned beams whose text holds the LM's
``<s>`` or ``</s>`` as a word: the program's ``replay.sentence_beams`` over ``replay.beams``, counted in
the batch replay. It says how much of a cell's answers passes through the device's scoring of the
sentence markers as words (0 where the labels cannot spell them).
"""


def read(rec):
    # the window's counters as cardbench/harness/program.py drains them into the record
    counters = ((rec.get("program") or {}).get("window") or {}).get("counters", {})
    if rec["kind"] != "batch" or not counters.get("replay.beams"):
        return None
    return counters.get("replay.sentence_beams", 0) / counters["replay.beams"]
