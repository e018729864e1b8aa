"""The port's kernels and their plain versions.

``KERNEL_WRAPPERS`` lists every wrapper of the package that launches a
hand-written CUDA kernel; each carries a ``launches`` count, which it raises
only where it launches its kernel. ``decode_attention_pallas`` launches the
decode kernel through ``paged_decode_attention``, so both counts rise.
"""

from scratchpad_tpu_torch.ops.attention import (
    decode_attention_pallas,
    paged_decode_attention,
    paged_decode_attention_quant,
    paged_extend_attention,
    paged_extend_attention_quant,
)
from scratchpad_tpu_torch.ops.ldmm import delta_matmul_grouped
from scratchpad_tpu_torch.ops.quant.w4_matmul import (
    quantize_rows_int8,
    w4a8_matmul,
    w4a16_matmul,
)

KERNEL_WRAPPERS = (
    paged_decode_attention,
    paged_extend_attention,
    paged_decode_attention_quant,
    paged_extend_attention_quant,
    quantize_rows_int8,
    w4a8_matmul,
    w4a16_matmul,
    delta_matmul_grouped,
    decode_attention_pallas,
)


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0


__all__ = ["KERNEL_WRAPPERS", "reset_launch_counts"]
