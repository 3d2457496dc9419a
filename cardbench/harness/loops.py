"""The loops that drive the program: batch calls in a closed loop, live streams in an open loop.

Every call into the program runs inside a span of the harness's own
(:class:`Spans`): its name, and its start and end on the host clock, by
which a trace's idle gaps are named.
"""
from __future__ import annotations

import contextlib
import heapq
import sys
import time
import traceback
from typing import Dict, List, Optional, Sequence

from .traffic import chunks as split_chunks


class Spans:
    """The harness's spans: ``(name, start_s, end_s)`` on ``time.perf_counter``."""

    def __init__(self) -> None:
        self.items: List[tuple] = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.items.append((name, t0, time.perf_counter()))


class Sample:
    """A seeded sample of the answers, kept as they come, so that a run holds only what it will judge.

    One answer drawn uniformly from the longest inputs offered, and ``n - 1``
    drawn uniformly from all answers offered (reservoir sampling): the same
    seed and the same answers give the same sample.
    """

    def __init__(self, n: int, rng) -> None:
        self.n, self.rng = n, rng
        self.items: List[tuple] = []
        self.offered = 0
        self.longest: Optional[tuple] = None  # size, key, answer
        self.ties = 0

    def offer(self, key, answer, size: int) -> None:
        if self.longest is None or size > self.longest[0]:
            self.longest, self.ties = (size, key, answer), 1
        elif size == self.longest[0]:
            self.ties += 1
            if self.rng.randint(self.ties) == 0:
                self.longest = (size, key, answer)
        if len(self.items) < self.n - 1:
            self.items.append((key, answer))
        else:
            j = self.rng.randint(self.offered + 1)
            if j < self.n - 1:
                self.items[j] = (key, answer)
        self.offered += 1

    def picks(self) -> List[tuple]:
        """``(key, answer)`` pairs, a longest input's first."""
        return ([] if self.longest is None else [self.longest[1:]]) + self.items


def _report(what: str) -> None:
    print(f"cardbench: {what} raised:\n{traceback.format_exc()}", file=sys.stderr)


class BatchLoop:
    """Closed loop: one ``decode_beams_batch`` call after another, cycling through a pool of batches."""

    def __init__(self, decoder, pool: Sequence[Sequence], call_kw: Dict, spans: Spans, sample: Sample) -> None:
        self.decoder, self.pool, self.call_kw, self.spans = decoder, pool, call_kw, spans
        self.sample = sample
        self.calls: List[Dict] = []  # batch index, start, end, frames answered
        self.attempted = self.failed = 0

    def call(self) -> Dict:
        with self.spans("prep"):
            b = len(self.calls) % len(self.pool)
            batch = self.pool[b]
        t0 = time.perf_counter()
        try:
            with self.spans("decode_beams_batch"):
                out = self.decoder.decode_beams_batch(batch, **self.call_kw)
            out = list(out) + [None] * (len(batch) - len(out))
        except Exception:  # a failed call is counted, and the run goes on to be judged
            _report("decode_beams_batch")
            out = [None] * len(batch)
        rec = dict(batch=b, t0=t0, t1=time.perf_counter(),
                   frames=sum(m.shape[0] for m, beams in zip(batch, out) if beams))
        self.calls.append(rec)
        self.attempted += len(batch)
        for r, beams in enumerate(out):
            self.failed += not beams
            self.sample.offer((b, r), beams, batch[r].shape[0])
        return rec

    def run(self, seconds: float) -> Dict:
        """Calls until ``seconds`` have passed; the window's start, its calls and its last return."""
        first = len(self.calls)
        start = time.perf_counter()
        while time.perf_counter() - start < seconds:
            self.call()
        return dict(start=start, end=self.calls[-1]["t1"], calls=self.calls[first:])


class StreamLoop:
    """Open loop: live streams, each chunk served once it falls due.

    ``traffic`` is a stream generator's output (``harness.traffic``): each
    stream's utterances, played back to back and then again, and the
    seconds after :meth:`schedule`'s ``t0`` at which its chunks fall due.
    Chunks are served one at a time in order of due time, a stream's next
    chunk once its last has returned; a chunk's latency runs from its due
    time to the return of its ``partial_decode_beams`` call. A stream gets
    its state (``get_starting_state``) when an utterance starts, the first
    ones before the window opens.
    """

    def __init__(self, decoder, traffic: Dict, start_kw: Dict, call_kw: Dict, spans: Spans,
                 sample: Sample) -> None:
        self.decoder, self.spans, self.sample = decoder, spans, sample
        self.start_kw, self.call_kw = start_kw, call_kw
        streams = traffic["streams"]
        self.streams = [[split_chunks(m, traffic["chunk_frames"]) for m in st["utterances"]] for st in streams]
        self.due = [iter(st["due"]) for st in streams]
        self.t0 = 0.0
        self.pos: List[List[int]] = [[0, 0] for _ in streams]  # utterance, chunk
        self.states: List = [None] * len(streams)
        self.views: List[List] = [[] for _ in streams]
        self.served: List[Dict] = []  # stream, utterance, chunk, due, start, end, failed
        self.finished = 0  # utterances whose every chunk was answered
        self.queue: List[tuple] = []

    def _new_state(self, s: int) -> None:
        with self.spans("get_starting_state"):
            self.states[s] = self.decoder.get_starting_state(**self.start_kw)
        self.views[s] = []

    def open(self) -> None:
        """Every stream's first state."""
        for s in range(len(self.streams)):
            self._new_state(s)

    def schedule(self, t0: float) -> None:
        """The loop opens at ``t0``: every stream's first chunk is due at ``t0`` plus its first due time."""
        self.t0 = t0
        for s in range(len(self.streams)):
            heapq.heappush(self.queue, (t0 + next(self.due[s]), s))

    def shift_to(self, now: float) -> float:
        """Move every due time later by as much as the next is overdue at ``now``, so that none is; the shift."""
        late = now - self.queue[0][0] if self.queue else 0.0
        if late > 0:
            self.queue = [(due + late, s) for due, s in self.queue]
            heapq.heapify(self.queue)
            self.t0 += late
        return max(late, 0.0)

    def _serve(self, due: float, s: int) -> None:
        u, c = self.pos[s]
        utt = self.streams[s][u % len(self.streams[s])]
        last = c == len(utt) - 1
        t0 = time.perf_counter()
        failed = False
        try:
            with self.spans("partial_decode_beams"):
                view = self.decoder.partial_decode_beams(self.states[s], utt[c], is_end=last, **self.call_kw)
        except Exception:  # counted as a failed chunk; the stream starts its next utterance
            _report("partial_decode_beams")
            view, failed, last = None, True, True
        t1 = time.perf_counter()
        self.served.append(dict(stream=s, utt=u, chunk=c, due=due, start=t0, end=t1, failed=failed))
        self.views[s].append(view)
        if last:
            if not failed:
                self.finished += 1
                self.sample.offer((s, u), self.views[s], self.frames_of(s, u))
            self.pos[s] = [u + 1, 0]
            self._new_state(s)
        else:
            self.pos[s][1] = c + 1
        heapq.heappush(self.queue, (self.t0 + next(self.due[s]), s))

    def serve_until(self, t_end: float) -> List[Dict]:
        """Serve every chunk due before ``t_end``, waiting for each that is not yet due; those served."""
        first = len(self.served)
        while self.queue and self.queue[0][0] < t_end:
            due, s = heapq.heappop(self.queue)
            wait = due - time.perf_counter()
            if wait > 0:
                with self.spans("wait"):
                    time.sleep(wait)
            self._serve(due, s)
        return self.served[first:]

    def frames_of(self, s: int, u: int) -> int:
        return sum(c.shape[0] for c in self.streams[s][u % len(self.streams[s])])


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """The ``q``-th percentile (linear between order statistics), None for no values."""
    if not values:
        return None
    import numpy as np

    return float(np.percentile(np.asarray(values, dtype=np.float64), q))
