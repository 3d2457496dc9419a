"""sentence_beams.stream: The share of the measured window's beams returned in the chunks' views whose
committed words hold the LM's ``<s>`` or ``</s>``: the program's ``replay.sentence_beams`` over
``replay.beams``, counted in the stream's replay.
"""


def read(rec):
    # the window's counters as cardbench/harness/program.py drains them into the record
    counters = ((rec.get("program") or {}).get("window") or {}).get("counters", {})
    if rec["kind"] != "stream" or not counters.get("replay.beams"):
        return None
    return counters.get("replay.sentence_beams", 0) / counters["replay.beams"]
