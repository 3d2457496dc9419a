"""Device-side building blocks: hashing, token tables and the kernels."""


def kernel_wrappers():
    """Every kernel wrapper with a ``launches`` counter."""
    from .backtrace import backtrace_paths
    from .commit import commit_words
    from .gather import gather_rows, probe_rows
    from .merge import expand_merge_prune, merge_prune
    from .replay import replay_winners
    from .walk import walk_partial

    return (expand_merge_prune, merge_prune, gather_rows, probe_rows, backtrace_paths, replay_winners,
            commit_words, walk_partial)
