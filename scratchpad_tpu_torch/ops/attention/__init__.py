from scratchpad_tpu_torch.ops.attention.decode_ablate import decode_ablate, decode_ablate_plain
from scratchpad_tpu_torch.ops.attention.gqa_decode import (
    decode_attention_gqa,
    make_decode_attention_tp,
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
    make_attention_ragged_tp,
    paged_extend_attention,
    paged_extend_attention_plain,
    paged_extend_attention_quant,
)



def attention_functions(backend: str, tp=None, heads=None):
    """The model's (decode, extend) attention under ``attention_backend``,
    the part of the JAX runner's choice (``model_runner.py:173-466``) that
    the port has: ``auto`` decodes through ``decode_attention_gqa`` and
    ``pallas`` through ``decode_attention_pallas``; both extend through
    ``attention_ragged`` (the JAX package's ``pallas`` extends through its
    XLA path, which the port keeps off the card). On a tensor-parallel rank
    (``tp``, a ``parallel.TPGroup``, with the model's (Hq, Hkv) ``heads``)
    each takes the rank-local wrapper of the same kernel (JAX :235-273,
    :418-424): ``pallas`` decodes through ``decode_attention_pallas`` (row
    9) on the rank's heads, where the JAX runner falls back to XLA with a
    warning (:272-273)."""
    decode = {"auto": decode_attention_gqa, "pallas": decode_attention_pallas}.get(backend)
    if decode is None:
        raise NotImplementedError(f"attention_backend={backend!r} is not ported")
    if tp is not None:
        return make_decode_attention_tp(decode, tp, heads), make_attention_ragged_tp(tp, heads)
    return decode, attention_ragged


__all__ = [
    "attention_functions",
    "decode_ablate",
    "decode_ablate_plain",
    "attention_ragged",
    "decode_attention_gqa",
    "decode_attention_pallas",
    "decode_attention_plain",
    "extend_attention_plain",
    "make_attention_ragged_tp",
    "make_decode_attention_tp",
    "paged_decode_attention",
    "paged_decode_attention_plain",
    "paged_decode_attention_quant",
    "paged_extend_attention",
    "paged_extend_attention_plain",
    "paged_extend_attention_quant",
    "quantize_rows",
    "write_kv",
]
