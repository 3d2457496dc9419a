"""Host utilities: input normalization, metrics and the prefix trie."""
