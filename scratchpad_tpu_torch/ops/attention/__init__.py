from scratchpad_tpu_torch.ops.attention.gqa_decode import (
    decode_attention_gqa,
    paged_decode_attention,
    paged_decode_attention_plain,
    paged_decode_attention_quant,
)
from scratchpad_tpu_torch.ops.attention.pallas_decode import decode_attention_pallas
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



def attention_functions(backend: str):
    """The model's (decode, extend) attention under ``attention_backend``,
    the part of the JAX runner's choice (``model_runner.py:173-466``) that
    the port has: ``auto`` decodes through ``decode_attention_gqa`` and
    ``pallas`` through ``decode_attention_pallas``; both extend through
    ``attention_ragged`` (the JAX package's ``pallas`` extends through its
    XLA path, which the port keeps off the card)."""
    decode = {"auto": decode_attention_gqa, "pallas": decode_attention_pallas}.get(backend)
    if decode is None:
        raise NotImplementedError(f"attention_backend={backend!r} is not ported")
    return decode, attention_ragged


__all__ = [
    "attention_functions",
    "attention_ragged",
    "decode_attention_gqa",
    "decode_attention_pallas",
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
