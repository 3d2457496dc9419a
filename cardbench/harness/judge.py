"""Whether the timed path's answers are right: the numbers compared with the reference, and their limits.

An answer is one utterance's output beams (batch cells) or one chunk's
ranked view (stream cells). For each answer compared, the program's top
beam is looked up among the reference's beams by everything it carries
but its scores: the text and its word frames, and the LM state (batch) or
the partial word and its frames (stream). Three numbers:

* ``missing``: answers due that never came, or came empty;
* ``top_gap``: the widest gap, in nats, by which the reference's score of
  the beam the program ranked first lies below the reference's best, over
  the answers compared (0 where both rank the same beam first; a ranking
  near a tie may swap within float32's rounding). A top beam the
  reference does not hold at all reads :data:`ABSENT`;
* ``score_err``: the widest difference between the program's scores of
  its top beam (acoustic and fused) and the reference's scores of the same
  beam, in nats (of the reference's first beam where it holds no such
  beam).

``correct`` holds where each number is at most its limit
(``cardbench/limits/<cell>.json``).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

ABSENT = 1e9


def _ints(frames) -> Tuple[int, int]:
    return (int(frames[0]), int(frames[1]))


def lm_state(state, words: Sequence) -> Optional[Tuple]:
    """An LM state's word ids read as words; an ensemble's state as the tuple of its members' contexts.

    ``words``: the LM's word list, or for an ensemble (a state with
    ``states``, pyctcdecode's ``MultiLMState``) one word list a member.
    """
    members = getattr(state, "states", None)
    if members is not None:
        return tuple(lm_state(s, w) for s, w in zip(members, words))
    ctx = getattr(state, "context", None)
    return None if ctx is None else tuple(words[i] if 0 <= i < len(words) else f"#{i}" for i in ctx)


def program_output(beams, words: Sequence) -> List[dict]:
    """A batch decode's beams of one utterance as plain data, the LM state read as words (:func:`lm_state`)."""
    out = []
    for b in beams:
        state = lm_state(b.last_lm_state, words)
        out.append(dict(text=b.text, frames=[(w, _ints(f)) for w, f in b.text_frames], state=state,
                        logit=float(b.logit_score), lm=float(b.lm_score)))
    return out


def program_view(view) -> List[dict]:
    """A stream chunk's ranked view as plain data."""
    return [dict(text=b.text, partial=b.partial_word, frames=[_ints(f) for f in b.text_frames],
                 pframes=_ints(b.partial_frames), logit=float(b.logit_score), lm=float(b.lm_score))
            for b in view]


def reference_view(view) -> List[dict]:
    return [dict(text=b.text, partial=b.partial, frames=[tuple(f) for f in b.frames], pframes=tuple(b.pframes),
                 logit=float(b.logit), lm=float(b.lm)) for b in view]


def _key(beam: dict) -> Tuple:
    return tuple((k, repr(beam[k])) for k in sorted(beam) if k not in ("logit", "lm"))


def compare(pairs: Sequence[Tuple[Optional[List[dict]], List[dict]]]) -> Dict[str, float]:
    """The numbers over ``(program answer, reference answer)`` pairs."""
    missing, top_gap, score_err = 0, 0.0, 0.0
    for got, want in pairs:
        if not got:
            missing += 1
            continue
        top = got[0]
        match = next((b for b in want if _key(b) == _key(top)), None)
        ref = want[0] if match is None else match
        top_gap = max(top_gap, ABSENT if match is None else want[0]["lm"] - match["lm"])
        score_err = max(score_err, abs(top["lm"] - ref["lm"]), abs(top["logit"] - ref["logit"]))
    return dict(missing=float(missing), top_gap=top_gap, score_err=score_err)


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(numbers[name] <= limits[name] for name in limits)
