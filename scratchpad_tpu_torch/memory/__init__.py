from scratchpad_tpu_torch.memory.page_allocator import PageAllocator, ReqSlotAllocator
from scratchpad_tpu_torch.memory.kv_cache import KVCache, KVCacheConfig, create_kv_cache
from scratchpad_tpu_torch.memory.radix_cache import RadixCache, MatchResult
from scratchpad_tpu_torch.memory.chunk_cache import ChunkCache

__all__ = [
    "PageAllocator",
    "ReqSlotAllocator",
    "KVCache",
    "KVCacheConfig",
    "create_kv_cache",
    "RadixCache",
    "MatchResult",
    "ChunkCache",
]
