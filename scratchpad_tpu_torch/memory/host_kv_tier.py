"""Host KV tier: pages the radix cache evicts survive in host memory.

Counterpart of ``scratchpad_tpu/memory/host_kv_tier.py``. The device pool
stays the hot tier; pages the radix cache must evict are copied into a
bounded host arena instead of being dropped, and a later prefix hit
promotes them into fresh device pages (one host-to-device copy instead of
a prefill).

Indexing is a per-page token trie per adapter (K/V depend on the active
topping, as the device-side ``TreeCacheGroup`` does). A trie node may be a
placeholder (slot -1) when its own page was not offloaded (ancestors evict
after descendants); placeholders never match but keep paths connected.

On the card the arena is pinned host memory. An eviction gathers its pages
on the compute stream (so it reads them as every earlier step left them)
and copies them to the arena on a side stream with ``non_blocking``
copies, after waiting for the compute stream. A promotion makes the
compute stream wait for the side stream, then copies its slots up on the
compute stream ahead of the forwards that read them; a later eviction's
copy into the same slot waits for that. No host read of the arena happens,
so nothing waits on the host. The arena holds one tensor a pool tensor (K,
V and an 8-bit pool's scales, or a latent pool's one tensor).
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch


class _Node:
    __slots__ = ("children", "slot", "t")

    def __init__(self):
        self.children: dict[tuple, "_Node"] = {}
        self.slot = -1  # host arena slot; -1 = placeholder
        self.t = 0.0


class HostKVTier:
    def __init__(self, runner, capacity_tokens: int):
        self.runner = runner
        self.ps = runner.page_size
        self.capacity_slots = max(capacity_tokens // self.ps, 1)
        self._arena: Optional[list[torch.Tensor]] = None  # each [slots, L, ps, ...]
        self._free = list(range(self.capacity_slots - 1, -1, -1))
        self._roots: dict[int, _Node] = {}
        self.stored_pages = 0
        self.restored_pages = 0
        self.cuda = runner.device.type == "cuda"
        self._stream = torch.cuda.Stream(runner.device) if self.cuda else None

    # ------------------------------------------------------------------ trie

    def _root(self, adapter: int) -> _Node:
        if adapter not in self._roots:
            self._roots[adapter] = _Node()
        return self._roots[adapter]

    def _walk(self, adapter: int, tokens: list[int], create: bool):
        """One trie node a page of ``tokens`` (page-aligned walk)."""
        node = self._root(adapter)
        out = []
        for i in range(0, len(tokens) - self.ps + 1, self.ps):
            key = tuple(tokens[i : i + self.ps])
            child = node.children.get(key)
            if child is None:
                if not create:
                    break
                child = _Node()
                node.children[key] = child
            out.append(child)
            node = child
        return out

    # ----------------------------------------------------------------- store

    def on_evict(self, adapter: int, tokens: list[int], page_ids: np.ndarray):
        """Radix-eviction hook: offload the node's pages before they free.

        ``tokens`` is the full root->node prefix; ``page_ids`` covers its
        LAST ``len(page_ids)`` pages (ancestors are still on the device)."""
        npg = len(page_ids)
        if npg == 0:
            return
        while len(self._free) < npg:
            if not self._drop_lru():
                return  # arena full of newer entries; skip offload
        pages = self.runner.gather_pages(np.asarray(page_ids, np.int64))
        if self._arena is None:
            self._arena = [
                torch.zeros((self.capacity_slots,) + p.shape[1:], dtype=p.dtype, pin_memory=self.cuda)
                for p in pages
            ]
        path = self._walk(adapter, tokens, create=True)
        now = time.monotonic()
        total = len(tokens) // self.ps
        copies = []
        for j, node in enumerate(path):
            node.t = now
            if j >= total - npg:
                if node.slot < 0:
                    node.slot = self._free.pop()
                copies.append((node.slot, j - (total - npg)))
        if self.cuda:
            self._stream.wait_stream(torch.cuda.current_stream(self.runner.device))
            with torch.cuda.stream(self._stream):
                for arena, p in zip(self._arena, pages):
                    p.record_stream(self._stream)
                    for slot, i in copies:
                        arena[slot].copy_(p[i], non_blocking=True)
        else:
            for arena, p in zip(self._arena, pages):
                for slot, i in copies:
                    arena[slot].copy_(p[i])
        self.stored_pages += npg

    def _drop_lru(self) -> bool:
        """Free the least-recently-touched materialized node's slot."""
        best = None
        stack = list(self._roots.values())
        while stack:
            n = stack.pop()
            for c in n.children.values():
                if c.slot >= 0 and (best is None or c.t < best.t):
                    best = c
                stack.append(c)
        if best is None:
            return False
        self._free.append(best.slot)
        best.slot = -1
        return True

    # ----------------------------------------------------------------- fetch

    def match(self, adapter: int, tokens: list[int], start_page: int) -> list[int]:
        """Host slots extending a device-resident prefix of ``start_page``
        pages: walk the token path (placeholders are fine inside the device
        prefix, whose pages are still on the device) and collect the
        contiguous materialized slots from ``start_page`` on."""
        slots = []
        now = time.monotonic()
        for j, node in enumerate(self._walk(adapter, list(tokens), create=False)):
            if j < start_page:
                continue
            if node.slot < 0:
                break
            node.t = now
            slots.append(node.slot)
        return slots

    def load(self, slots: list[int]) -> list[torch.Tensor]:
        """The slots' pages on the device, ``[n, L, ps, ...]`` a pool
        tensor, copied on the compute stream after every pending offload."""
        dev = self.runner.device
        if self.cuda:
            torch.cuda.current_stream(dev).wait_stream(self._stream)
        out = []
        for arena in self._arena:
            t = torch.empty((len(slots),) + arena.shape[1:], dtype=arena.dtype, device=dev)
            for i, s in enumerate(slots):
                t[i].copy_(arena[s], non_blocking=True)
            out.append(t)
        self.restored_pages += len(slots)
        return out

    def reset(self) -> None:
        self._roots.clear()
        self._free = list(range(self.capacity_slots - 1, -1, -1))
