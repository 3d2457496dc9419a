"""parity_3gram: a synthetic 3-gram ARPA with the counts of LibriSpeech's 3-gram.pruned.1e-7.arpa.

Recipe keys (the configuration's ``lm``): ``order`` (3), ``n_vocab``,
``n_bigrams``, ``n_trigrams`` and ``seed`` (``harness.data.write_parity_arpa``:
200k words, 1.5M bigrams, 1.1M trigrams at the published counts). The
program loads the ARPA text, as users load theirs; the reference reads the
same file.
"""
import os

from cardbench.harness.data import write_parity_arpa


def files(recipe, cache_dir, key):
    """Write ``<key>.arpa`` and ``<key>.words`` (the vocabulary) into ``cache_dir`` once; their paths."""
    if recipe["order"] != 3:
        raise ValueError(f"parity_3gram is a 3-gram; the recipe asks for order {recipe['order']}")
    arpa, words = cache_dir / f"{key}.arpa", cache_dir / f"{key}.words"
    if not (arpa.is_file() and words.is_file()):
        cache_dir.mkdir(parents=True, exist_ok=True)
        tmp = cache_dir / f"{key}.arpa.part{os.getpid()}"
        vocab = write_parity_arpa(str(tmp), recipe["n_vocab"], recipe["n_bigrams"], recipe["n_trigrams"],
                                  recipe["seed"])
        os.replace(tmp, arpa)
        tmp_words = cache_dir / f"{key}.words.part{os.getpid()}"
        tmp_words.write_text("\n".join(vocab) + "\n", encoding="utf-8")
        os.replace(tmp_words, words)
    return dict(load=arpa, arpa=arpa, words=words)
