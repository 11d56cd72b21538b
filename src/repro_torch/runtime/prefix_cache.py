"""Radix prefix index over token-id block chains.

Host-side trie mapping full ``block_size``-token chunks of a prompt to the
physical KV-pool blocks that already hold their K/V, so a new request that
shares a prefix with earlier traffic can *link* those blocks into its block
table instead of re-running prefill dot-products over them.

The PyTorch port keeps its own copy of the reference module
(``repro.runtime.prefix_cache``); it is plain Python on both sides.

Division of labour (mirrors the BlockAllocator contract in
``launch/serve.py``):

- this module owns the *index*: which token chains are cached and which
  physical block backs each chunk, plus LRU recency for eviction ordering;
- the ``BlockAllocator`` owns *lifetime*: refcounts, the idle set, and the
  free list.  The engine is the only coordinator — it retains blocks on a
  hit, registers new chains after admission, and evicts leaf-first when the
  pool is under pressure.

Everything here is plain host Python: no tensor is touched.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple


class PrefixNode:
    """One cached block: a full ``block_size``-token chunk plus the physical
    pool block that holds its K/V."""

    __slots__ = ("key", "block", "parent", "children", "last_use")

    def __init__(self, key: Tuple[int, ...], block: int,
                 parent: Optional["PrefixNode"]):
        self.key = key
        self.block = block
        self.parent = parent
        self.children: Dict[Tuple[int, ...], "PrefixNode"] = {}
        self.last_use = 0

    def __repr__(self):  # pragma: no cover - debugging aid
        return f"PrefixNode(block={self.block}, children={len(self.children)})"


class PrefixCache:
    """Radix/trie index at block granularity.

    Only *full* chunks are ever indexed: a chain for an L-token prompt has
    ``L // block_size`` nodes.  Partial tail blocks are still being written
    by their owning slot and are never shared.
    """

    def __init__(self, block_size: int = 8):
        if block_size < 1:
            raise ValueError("block_size must be >= 1")
        self.block_size = int(block_size)
        self._root = PrefixNode((), -1, None)
        self._tick = 0
        self.n_nodes = 0

    # -- chunking ----------------------------------------------------------

    def _chunks(self, tokens: Sequence[int]) -> List[Tuple[int, ...]]:
        bs = self.block_size
        n_full = len(tokens) // bs
        return [tuple(int(t) for t in tokens[i * bs:(i + 1) * bs])
                for i in range(n_full)]

    # -- queries -----------------------------------------------------------

    def match(self, tokens: Sequence[int]) -> List[PrefixNode]:
        """Longest chain of cached full chunks prefixing ``tokens``.

        Pure query: no recency stamping, no counters — the engine stamps via
        :meth:`insert` only when an admission actually goes through, so a
        deferred (capacity-blocked) head request cannot skew LRU order.
        """
        node = self._root
        out: List[PrefixNode] = []
        for chunk in self._chunks(tokens):
            child = node.children.get(chunk)
            if child is None:
                break
            out.append(child)
            node = child
        return out

    # -- updates -----------------------------------------------------------

    def insert(self, tokens: Sequence[int], blocks: Sequence[int]
               ) -> List[int]:
        """Index the full-chunk chain of ``tokens`` backed by ``blocks``.

        ``blocks[i]`` is the physical block holding chunk ``i``'s K/V.
        Existing nodes are kept (first writer wins — a duplicate physical
        copy admitted concurrently simply stays request-private) and the
        whole chain's recency is stamped.  Returns the physical blocks of
        *newly created* nodes; the caller must ``register_cached`` exactly
        those with the allocator.
        """
        chunks = self._chunks(tokens)
        if len(blocks) < len(chunks):
            raise ValueError(
                f"chain needs {len(chunks)} blocks, got {len(blocks)}")
        self._tick += 1
        node = self._root
        new_blocks: List[int] = []
        for i, chunk in enumerate(chunks):
            child = node.children.get(chunk)
            if child is None:
                child = PrefixNode(chunk, int(blocks[i]), node)
                node.children[chunk] = child
                self.n_nodes += 1
                new_blocks.append(child.block)
            child.last_use = self._tick
            node = child
        return new_blocks

    def remove(self, node: PrefixNode) -> None:
        """Drop a leaf node from the index (its block is being evicted)."""
        if node.children:
            raise ValueError("only leaf nodes can be removed (leaf-first LRU)")
        if node.parent is None:
            raise ValueError("cannot remove the root")
        del node.parent.children[node.key]
        node.parent = None
        self.n_nodes -= 1

    # -- eviction ordering -------------------------------------------------

    def leaves_lru(self) -> List[PrefixNode]:
        """All leaf nodes, least-recently-used first.

        Leaf-first keeps every cached chain reachable: an interior block is
        only ever evicted after all its descendants have gone.
        """
        leaves: List[PrefixNode] = []
        stack = list(self._root.children.values())
        while stack:
            n = stack.pop()
            if n.children:
                stack.extend(n.children.values())
            else:
                leaves.append(n)
        leaves.sort(key=lambda n: n.last_use)
        return leaves

    def __len__(self) -> int:
        return self.n_nodes
