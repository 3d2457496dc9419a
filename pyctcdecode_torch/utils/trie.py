"""Character prefix trie.

Self-contained replacement for the ``pygtrie.CharTrie`` functionality the
reference relies on (prefix membership and shortest-completion queries,
ref ``language_model.py:135-150, 263, 331``).
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional


class _Node:
    __slots__ = ("children", "terminal", "min_depth")

    def __init__(self) -> None:
        self.children: Dict[str, "_Node"] = {}
        self.terminal = False
        # length of the shortest key passing through this node
        self.min_depth = 0


class CharTrie:
    """Prefix trie over unicode strings.

    ``has_prefix(p)`` answers "is p a prefix of any inserted key" (including
    p being a key itself); ``shortest_completion_len(p)`` returns the length
    of the shortest key that has prefix p.
    """

    def __init__(self, keys: Optional[Iterable[str]] = None) -> None:
        self._root = _Node()
        self._size = 0
        if keys is not None:
            for k in keys:
                self.add(k)

    @classmethod
    def fromkeys(cls, keys: Iterable[str]) -> "CharTrie":
        return cls(keys)

    def __len__(self) -> int:
        return self._size

    def add(self, key: str) -> None:
        """Insert one key, updating shortest-completion metadata."""
        node = self._root
        depth = len(key)
        if self._size == 0 or depth < node.min_depth:
            node.min_depth = depth
        for ch in key:
            nxt = node.children.get(ch)
            if nxt is None:
                nxt = _Node()
                node.children[ch] = nxt
                nxt.min_depth = depth
            elif depth < nxt.min_depth:
                nxt.min_depth = depth
            node = nxt
        if not node.terminal:
            node.terminal = True
            self._size += 1

    def _walk(self, prefix: str) -> Optional[_Node]:
        node = self._root
        for ch in prefix:
            node = node.children.get(ch)
            if node is None:
                return None
        return node

    def has_prefix(self, prefix: str) -> bool:
        """True when any key starts with ``prefix`` (or equals it)."""
        if self._size == 0:
            return False
        return self._walk(prefix) is not None

    def __contains__(self, key: str) -> bool:
        node = self._walk(key)
        return node is not None and node.terminal

    def shortest_completion_len(self, prefix: str) -> int:
        """Length of the shortest key with the given prefix (0 when none)."""
        if self._size == 0:
            return 0
        node = self._walk(prefix)
        if node is None:
            return 0
        return node.min_depth
