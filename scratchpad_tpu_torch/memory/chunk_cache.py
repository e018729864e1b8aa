"""No-dedup cache used when the radix cache is disabled.

Analogue of ChunkCache (reference: scratchpad/memory/chunk_cache.py:16-85):
keeps per-request page lists alive across prefill chunks but never shares
pages between requests.
"""

from __future__ import annotations

import numpy as np

from scratchpad_tpu_torch.memory.radix_cache import MatchResult, TreeNode


class ChunkCache:
    """Implements the RadixCache interface with caching disabled."""

    def __init__(self, page_size: int):
        self.page_size = page_size
        self.disable = True
        self.root = TreeNode()
        self.root.lock_ref = 1

    def match_prefix(self, token_ids) -> MatchResult:
        return MatchResult(np.empty(0, np.int32), self.root)

    def insert(self, token_ids, page_ids) -> int:
        return 0

    def inc_lock_ref(self, node) -> None:
        pass

    def dec_lock_ref(self, node) -> None:
        pass

    def evict(self, num_pages, free_fn) -> int:
        return 0

    @property
    def evictable_pages(self) -> int:
        return 0

    @property
    def protected_pages(self) -> int:
        return 0

    def reset(self) -> None:
        pass
