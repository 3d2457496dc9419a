"""stream: live streams at a steady pace, their offsets spread evenly over one chunk period.

Mix keys: ``streams``; ``utterances`` a stream plays back to back (then
again from the first), their frame counts spread evenly over ``frames``,
each stream in its own order; ``chunk_s`` seconds of audio a chunk. Stream
``s``'s ``k``-th chunk (counted over its utterances) falls due
``s * chunk_s / streams + k * chunk_s`` seconds after the loop opens: the
pace of live audio. The seed changes the words, the noise and the order,
not the sizes or the arrival times.
"""
import itertools

from cardbench.harness.traffic import frame_counts, seeded, utterances


def steady(offset, period):
    """``offset``, then every ``period`` seconds after it."""
    return (offset + k * period for k in itertools.count())


def make(mix, seed, ctx):
    counts = frame_counts(mix["frames"], mix["utterances"])
    period, n = mix["chunk_s"], mix["streams"]
    streams = []
    for s in range(n):
        rng = seeded(seed, 2, s)
        due = steady(s * period / n, period)
        streams.append(dict(utterances=utterances(rng, list(rng.permutation(counts)), ctx), due=due))
    return dict(kind="stream", chunk_frames=int(round(period / ctx.frame_s)), streams=streams)
