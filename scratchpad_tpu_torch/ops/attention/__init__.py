from scratchpad_tpu_torch.ops.attention.gqa_decode import (
    decode_attention_gqa,
    paged_decode_attention,
    paged_decode_attention_plain,
    paged_decode_attention_quant,
)
from scratchpad_tpu_torch.ops.attention.plain_backend import (
    decode_attention_plain,
    extend_attention_plain,
    quantize_rows,
    write_kv,
)
from scratchpad_tpu_torch.ops.attention.ragged_backend import (
    attention_ragged,
    paged_extend_attention,
    paged_extend_attention_plain,
    paged_extend_attention_quant,
)

__all__ = [
    "attention_ragged",
    "decode_attention_gqa",
    "decode_attention_plain",
    "extend_attention_plain",
    "paged_decode_attention",
    "paged_decode_attention_plain",
    "paged_decode_attention_quant",
    "paged_extend_attention",
    "paged_extend_attention_plain",
    "paged_extend_attention_quant",
    "quantize_rows",
    "write_kv",
]
