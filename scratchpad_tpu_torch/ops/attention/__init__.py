from scratchpad_tpu_torch.ops.attention.gqa_decode import (
    decode_attention_gqa,
    paged_decode_attention,
    paged_decode_attention_plain,
)
from scratchpad_tpu_torch.ops.attention.plain_backend import (
    decode_attention_plain,
    extend_attention_plain,
    write_kv,
)
from scratchpad_tpu_torch.ops.attention.ragged_backend import (
    attention_ragged,
    paged_extend_attention,
    paged_extend_attention_plain,
)

# every kernel wrapper of the package, each with its launch count
KERNEL_WRAPPERS = (paged_decode_attention, paged_extend_attention)


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0


__all__ = [
    "KERNEL_WRAPPERS",
    "attention_ragged",
    "decode_attention_gqa",
    "decode_attention_plain",
    "extend_attention_plain",
    "paged_decode_attention",
    "paged_decode_attention_plain",
    "paged_extend_attention",
    "paged_extend_attention_plain",
    "reset_launch_counts",
    "write_kv",
]
