"""Radix-tree prefix cache over KV pages.

Re-implements the semantics of the reference RadixCache
(reference: scratchpad/memory/radix_cache.py:15-420) at *page* granularity:
keys are token-id sequences truncated to multiples of ``page_size`` and node
values are KV page ids, so a cache hit hands the scheduler whole pages it can
point a request's page table at. The reference works token-granular
(page_size=1) with an optional paged key match (_key_match_paged:57); on TPU
pages are the DMA unit so page alignment is the native design.

Semantics preserved from the reference:
- longest-prefix match returns the matched pages plus the deepest node, whose
  lock_ref the caller bumps to protect the path from eviction while in flight
  (inc/dec_lock_ref, reference :253-267)
- insert dedupes against existing paths and reports how many of the caller's
  pages were duplicates so the caller can return them to the allocator
  (cache_finished_req / cache_unfinished_req, reference :145-221)
- eviction walks unlocked leaves in LRU order (reference evict :230)
- nodes split at page boundaries only (reference _split_node :326)
"""

from __future__ import annotations

import dataclasses
import heapq
import time
from typing import Callable, Optional

import numpy as np


class TreeNode:
    __slots__ = (
        "children",
        "parent",
        "key",
        "value",
        "lock_ref",
        "last_access_time",
        "_id",
    )
    _counter = 0

    def __init__(self):
        self.children: dict[tuple, "TreeNode"] = {}
        self.parent: Optional["TreeNode"] = None
        self.key: list[int] = []  # token ids, len % page_size == 0
        self.value: Optional[np.ndarray] = None  # page ids, len == len(key)//ps
        self.lock_ref = 0
        self.last_access_time = time.monotonic()
        TreeNode._counter += 1
        self._id = TreeNode._counter

    def __lt__(self, other: "TreeNode"):
        return self.last_access_time < other.last_access_time


@dataclasses.dataclass
class MatchResult:
    page_ids: np.ndarray  # matched prefix pages, concatenated root->leaf
    last_node: TreeNode

    @property
    def num_pages(self) -> int:
        return len(self.page_ids)


class RadixCache:
    def __init__(self, page_size: int, disable: bool = False):
        self.page_size = page_size
        self.disable = disable
        # optional host-tier hook: on_evict(full_prefix_tokens, page_ids)
        # runs before a node's pages are freed (memory/host_kv_tier.py)
        self.on_evict = None
        self.reset()

    def reset(self) -> None:
        self.root = TreeNode()
        self.root.lock_ref = 1  # root is never evictable
        self._evictable_pages = 0
        self._protected_pages = 0

    # ------------------------------------------------------------------ match

    def _first_page(self, key: list[int]) -> tuple:
        return tuple(key[: self.page_size])

    def _page_aligned(self, token_ids: list[int]) -> list[int]:
        n = (len(token_ids) // self.page_size) * self.page_size
        return token_ids[:n]

    def _key_match(self, a: list[int], b: list[int]) -> int:
        """Longest common prefix of a and b in whole pages; returns #tokens."""
        ps = self.page_size
        n = min(len(a), len(b))
        matched = 0
        for i in range(0, n - ps + 1, ps):
            if a[i : i + ps] == b[i : i + ps]:
                matched += ps
            else:
                break
        return matched

    def match_prefix(self, token_ids: list[int]) -> MatchResult:
        """Longest page-aligned prefix of token_ids present in the tree."""
        if self.disable:
            return MatchResult(np.empty(0, np.int32), self.root)
        key = self._page_aligned(list(token_ids))
        pages: list[np.ndarray] = []
        node = self.root
        now = time.monotonic()
        node.last_access_time = now
        while key:
            child = node.children.get(self._first_page(key))
            if child is None:
                break
            child.last_access_time = now
            matched = self._key_match(child.key, key)
            if matched < len(child.key):
                if matched == 0:
                    break
                child = self._split_node(child, matched)
                pages.append(child.value)
                node = child
                break
            pages.append(child.value)
            node = child
            key = key[matched:]
        out = (
            np.concatenate(pages).astype(np.int32)
            if pages
            else np.empty(0, np.int32)
        )
        return MatchResult(out, node)

    def _split_node(self, node: TreeNode, matched_tokens: int) -> TreeNode:
        """Split node at a page boundary; returns the new upper node."""
        ps = self.page_size
        upper = TreeNode()
        upper.key = node.key[:matched_tokens]
        upper.value = node.value[: matched_tokens // ps]
        upper.parent = node.parent
        upper.lock_ref = node.lock_ref
        upper.children = {self._first_page(node.key[matched_tokens:]): node}
        upper.parent.children[self._first_page(upper.key)] = upper
        node.parent = upper
        node.key = node.key[matched_tokens:]
        node.value = node.value[matched_tokens // ps :]
        return upper

    # ----------------------------------------------------------------- insert

    def insert(self, token_ids: list[int], page_ids: np.ndarray) -> int:
        """Insert a page-aligned sequence owning ``page_ids``.

        Returns the number of *duplicate pages*: the caller handed us pages for
        a prefix already in the tree; the caller must free its first N pages
        and use the tree's copies instead (obtain them via match_prefix).
        """
        if self.disable:
            return 0
        key = self._page_aligned(list(token_ids))
        ps = self.page_size
        assert len(page_ids) >= len(key) // ps, "fewer pages than key pages"
        page_ids = np.asarray(page_ids, dtype=np.int32)[: len(key) // ps]
        node = self.root
        now = time.monotonic()
        dup_pages = 0
        while key:
            node.last_access_time = now
            child = node.children.get(self._first_page(key))
            if child is None:
                new = TreeNode()
                new.key = key
                new.value = page_ids[: len(key) // ps].copy()
                new.parent = node
                node.children[self._first_page(key)] = new
                self._evictable_pages += len(new.value)
                return dup_pages
            matched = self._key_match(child.key, key)
            if matched < len(child.key):
                child = self._split_node(child, matched)
            dup_pages += matched // ps
            key = key[matched:]
            page_ids = page_ids[matched // ps :]
            node = child
        return dup_pages

    # ------------------------------------------------------------- lock / evict

    def inc_lock_ref(self, node: TreeNode) -> None:
        """Protect the path root->node from eviction (a root, also that of
        a tree ``TreeCacheGroup`` has dropped since the match, is a no-op)."""
        while node is not None and node.parent is not None:
            if node.lock_ref == 0:
                n = len(node.value)
                self._evictable_pages -= n
                self._protected_pages += n
            node.lock_ref += 1
            node = node.parent

    def dec_lock_ref(self, node: TreeNode) -> None:
        while node is not None and node.parent is not None:
            assert node.lock_ref > 0, "unbalanced dec_lock_ref"
            node.lock_ref -= 1
            if node.lock_ref == 0:
                n = len(node.value)
                self._evictable_pages += n
                self._protected_pages -= n
            node = node.parent

    def evict(self, num_pages: int, free_fn: Callable[[np.ndarray], None]) -> int:
        """Evict up to num_pages from unlocked leaves, LRU-first.

        free_fn receives page ids to return to the allocator. Returns pages
        actually evicted.
        """
        if self.disable:
            return 0
        leaves = [n for n in self._iter_nodes() if not n.children and n.lock_ref == 0]
        heapq.heapify(leaves)
        evicted = 0
        while leaves and evicted < num_pages:
            node = heapq.heappop(leaves)
            if node is self.root:
                break
            if self.on_evict is not None:
                self.on_evict(self._full_key(node), node.value)
            free_fn(node.value)
            evicted += len(node.value)
            self._evictable_pages -= len(node.value)
            parent = node.parent
            del parent.children[self._first_page(node.key)]
            if parent is not self.root and not parent.children and parent.lock_ref == 0:
                heapq.heappush(leaves, parent)
        return evicted

    def _full_key(self, node: TreeNode) -> list[int]:
        """Token prefix root->node (for the host-tier trie key)."""
        parts = []
        n = node
        while n is not None and n is not self.root:
            parts.append(n.key)
            n = n.parent
        out: list[int] = []
        for k in reversed(parts):
            out.extend(k)
        return out

    # ------------------------------------------------------------------ stats

    def _iter_nodes(self):
        stack = [self.root]
        while stack:
            n = stack.pop()
            if n is not self.root:
                yield n
            stack.extend(n.children.values())

    @property
    def evictable_pages(self) -> int:
        return self._evictable_pages

    @property
    def protected_pages(self) -> int:
        return self._protected_pages

    @property
    def total_pages(self) -> int:
        return self._evictable_pages + self._protected_pages

    def match_prefix_for(self, req) -> MatchResult:
        return self.match_prefix(req.origin_input_ids)

    def pretty_print(self) -> str:
        lines = []

        def rec(node, depth):
            for child in node.children.values():
                lines.append(
                    "  " * depth
                    + f"[{len(child.key)} tok, {len(child.value)} pg, lock={child.lock_ref}] "
                    + str(child.key[:8])
                )
                rec(child, depth + 1)

        rec(self.root, 0)
        return "\n".join(lines)
