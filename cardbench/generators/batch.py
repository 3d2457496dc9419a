"""batch: a closed loop's pool of batches, every batch of the same sizes.

Mix keys: ``rows`` utterances a call, their frame counts spread evenly over
``frames`` ([shortest, longest]; the same counts in every batch and for
every seed, each batch in its own order), ``pool`` distinct batches that the
loop cycles through. Utterances follow the dev-other noise model. The seed
changes the words, the noise and the order, not the work.
"""
from cardbench.harness.traffic import frame_counts, seeded, utterances


def make(mix, seed, ctx):
    counts = frame_counts(mix["frames"], mix["rows"])
    pool = []
    for b in range(mix["pool"]):
        rng = seeded(seed, 1, b)
        pool.append(utterances(rng, list(rng.permutation(counts)), ctx))
    return dict(kind="batch", pool=pool)
