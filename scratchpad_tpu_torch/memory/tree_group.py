"""A family of radix caches keyed by adapter (topping) id.

KV contents depend on the active LoRA adapter (k/v projections may carry
adapter deltas), so prefix reuse is only sound within the same adapter.
The reference keys its radix cache by token ids alone and mixes adapter KV;
here each adapter id gets its own tree sharing one page pool.
"""

from __future__ import annotations

from typing import Callable

from scratchpad_tpu_torch.memory.chunk_cache import ChunkCache
from scratchpad_tpu_torch.memory.radix_cache import RadixCache


class TreeCacheGroup:
    def __init__(self, page_size: int, disable: bool = False):
        self.page_size = page_size
        self.disable = disable
        self._trees: dict[int, RadixCache] = {}
        self._evict_hook = None  # (adapter, tokens, pages) -> None
        self.get(0)

    def set_evict_hook(self, hook) -> None:
        """Install a host-tier offload hook on every (current and future)
        adapter tree; hook(adapter_idx, full_prefix_tokens, page_ids)."""
        self._evict_hook = hook
        for idx, tree in self._trees.items():
            if hasattr(tree, "on_evict"):
                tree.on_evict = (
                    lambda toks, pages, _a=idx: hook(_a, toks, pages)
                )

    def get(self, topping_idx: int = 0):
        if topping_idx not in self._trees:
            if self.disable:
                self._trees[topping_idx] = ChunkCache(self.page_size)
            else:
                tree = RadixCache(self.page_size)
                if self._evict_hook is not None:
                    hook = self._evict_hook
                    tree.on_evict = (
                        lambda toks, pages, _a=topping_idx: hook(_a, toks, pages)
                    )
                self._trees[topping_idx] = tree
        return self._trees[topping_idx]

    def for_req(self, req):
        return self.get(getattr(req, "topping_idx", 0))

    @property
    def evictable_pages(self) -> int:
        return sum(t.evictable_pages for t in self._trees.values())

    @property
    def protected_pages(self) -> int:
        return sum(t.protected_pages for t in self._trees.values())

    def evict(self, num_pages: int, free_fn: Callable) -> int:
        """Evict across trees, draining the largest evictable first."""
        done = 0
        for tree in sorted(
            self._trees.values(), key=lambda t: -t.evictable_pages
        ):
            if done >= num_pages:
                break
            done += tree.evict(num_pages - done, free_fn)
        return done

    def reset(self) -> None:
        for t in self._trees.values():
            t.reset()
