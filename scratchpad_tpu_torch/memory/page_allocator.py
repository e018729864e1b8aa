"""Host-side allocators for KV pages and request slots.

TPU-native rework of the reference's token-granular free-list pools
(reference: scratchpad/memory/pool.py:13-255). The KV pool is allocated in
*pages* of ``page_size`` tokens so the Pallas attention kernels can DMA
contiguous chunks from HBM; the reference uses page_size=1 over CUDA gathers.

Allocators are pure host-side numpy; the device only ever sees page tables
(int32 arrays) and flat slot indices. ``slot = page_id * page_size + offset``.
"""

from __future__ import annotations

import numpy as np
from typing import Optional


class PageAllocator:
    """LIFO free-list over KV pages.

    Mirrors TokenToKVPoolAllocator semantics (reference:
    scratchpad/memory/pool.py:189-255) at page granularity, including
    ``free_group`` batching and state backup/restore used around retraction.
    """

    def __init__(self, num_pages: int, page_size: int):
        assert num_pages > 0 and page_size > 0
        self.num_pages = num_pages
        self.page_size = page_size
        self._free = list(range(num_pages - 1, -1, -1))  # pop() yields page 0 first
        self._free_group: Optional[list[np.ndarray]] = None

    @property
    def available_pages(self) -> int:
        return len(self._free)

    @property
    def available_tokens(self) -> int:
        return len(self._free) * self.page_size

    def pages_needed(self, num_tokens: int) -> int:
        return -(-num_tokens // self.page_size)

    def alloc(self, num_pages: int) -> Optional[np.ndarray]:
        """Allocate ``num_pages`` pages; None if not enough free."""
        if num_pages > len(self._free):
            return None
        out = np.array([self._free.pop() for _ in range(num_pages)], dtype=np.int32)
        return out

    def free(self, page_ids: np.ndarray) -> None:
        if self._free_group is not None:
            self._free_group.append(np.asarray(page_ids, dtype=np.int32))
            return
        self._free.extend(int(p) for p in np.asarray(page_ids).reshape(-1))
        assert len(self._free) <= self.num_pages, "double free of KV pages"

    # -- deferred free: pages freed while a device step that may still read
    #    them is in flight are held until the step's results are processed
    #    (reference: scheduler.py free_group begin/end around result handling)
    def free_group_begin(self) -> None:
        self._free_group = []

    def free_group_end(self) -> None:
        group, self._free_group = self._free_group, None
        if group:
            for ids in group:
                self.free(ids)

    # -- state backup/restore around speculative admission
    def backup_state(self) -> list[int]:
        return list(self._free)

    def restore_state(self, state: list[int]) -> None:
        self._free = list(state)

    def clear(self) -> None:
        self._free = list(range(self.num_pages - 1, -1, -1))
        self._free_group = None


class ReqSlotAllocator:
    """Free-list over request slots (rows of the page table).

    Analogue of ReqToTokenPool (reference: scratchpad/memory/pool.py:13-72),
    but the table maps request-slot -> page ids (not per-token slots).
    """

    def __init__(self, max_reqs: int, max_pages_per_req: int):
        self.max_reqs = max_reqs
        self.max_pages_per_req = max_pages_per_req
        # Host-side page table; rows are device_put per batch as needed.
        self.page_table = np.zeros((max_reqs, max_pages_per_req), dtype=np.int32)
        self._free = list(range(max_reqs - 1, -1, -1))

    @property
    def available_slots(self) -> int:
        return len(self._free)

    def alloc(self) -> Optional[int]:
        if not self._free:
            return None
        return self._free.pop()

    def free(self, slot: int) -> None:
        self.page_table[slot] = 0
        self._free.append(slot)
        assert len(self._free) <= self.max_reqs, "double free of req slot"

    def write_pages(self, slot: int, start_page: int, page_ids: np.ndarray) -> None:
        n = len(page_ids)
        assert start_page + n <= self.max_pages_per_req, "request exceeds max pages"
        self.page_table[slot, start_page : start_page + n] = page_ids

    def clear(self) -> None:
        self.page_table[:] = 0
        self._free = list(range(self.max_reqs - 1, -1, -1))
