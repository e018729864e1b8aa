"""Import pre-quantized HF checkpoints (AutoAWQ / AutoGPTQ int4) bit-exact.

Counterpart of ``scratchpad_tpu/ops/quant/import_hf.py``: a numpy copy of its
unpacking. The checkpoint's nibbles become ``w4a16.QuantizedLinear`` nibble
planes with no dequantize/requantize round trip, and
``weight_loader.quantized_layer_state`` packs them into the kernels' layout.
The on-disk formats:

- **AWQ** (``quant_method: "awq"``): ``qweight`` int32 [In, Out/8] (eight
  4-bit values per int32 along Out, nibble order [0,2,4,6,1,3,5,7]),
  ``qzeros`` int32 [In/g, Out/8] (same packing), ``scales`` [In/g, Out].
- **GPTQ** (``quant_method: "gptq"``): ``qweight`` int32 [In/8, Out] (packed
  along In, sequential nibble order), ``qzeros`` int32 [In/g, Out/8] storing
  ``z - 1`` (v1; ``checkpoint_format: "gptq_v2"`` stores ``z``), ``scales``
  [In/g, Out]. A v1 zero can therefore reach 16.

Both dequantize as ``w = (q - z) * s``. Act-order GPTQ (a non-trivial
``g_idx``) is refused. Scales and zeros are kept in bf16, the storage the
kernels read (the JAX package keeps them in the model dtype).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from scratchpad_tpu_torch.ops.quant.w4a16 import QUANT_TARGETS, QuantizedLinear

# AWQ interleaves nibbles so a 128-bit lane holds 8 consecutive logical
# columns in this order; the inverse permutation restores logical order.
_AWQ_ORDER = np.array([0, 2, 4, 6, 1, 3, 5, 7])
_AWQ_INV = np.argsort(_AWQ_ORDER)

_SHIFTS = (np.arange(8, dtype=np.uint32) * 4)[None, None, :]


def _unpack_int32_nibbles(packed: np.ndarray) -> np.ndarray:
    """int32 [R, C] -> uint8 [R, C, 8] (nibble k = bits 4k..4k+3)."""
    u = packed.astype(np.uint32)[..., None]
    return ((u >> _SHIFTS) & 0xF).astype(np.uint8)


def unpack_awq(qweight, qzeros, scales):
    """AWQ tensors -> (q u8 [In, Out], z f32 [G, Out], s f32 [G, Out])."""
    q = _unpack_int32_nibbles(qweight)[..., _AWQ_INV]  # [In, Out/8, 8]
    q = q.reshape(qweight.shape[0], -1)
    z = _unpack_int32_nibbles(qzeros)[..., _AWQ_INV]
    z = z.reshape(qzeros.shape[0], -1).astype(np.float32)
    return q, z, np.asarray(scales, np.float32)


def unpack_gptq(qweight, qzeros, scales, *, v2: bool = False, g_idx=None):
    """GPTQ tensors -> (q u8 [In, Out], z f32 [G, Out], s f32 [G, Out])."""
    if g_idx is not None:
        g = np.asarray(g_idx)
        expected = np.arange(len(g)) // (len(g) // scales.shape[0])
        if not np.array_equal(g, expected):
            raise NotImplementedError(
                "GPTQ act-order (desc_act=True) checkpoints are not "
                "supported: rows are permuted across quant groups"
            )
    # qweight packs the IN dim: int32 row r holds logical rows 8r..8r+7
    q = _unpack_int32_nibbles(qweight)  # [In/8, Out, 8]
    q = q.transpose(0, 2, 1).reshape(-1, qweight.shape[1])  # [In, Out]
    z = _unpack_int32_nibbles(qzeros).reshape(qzeros.shape[0], -1)
    z = z.astype(np.float32) + (0.0 if v2 else 1.0)
    return q, z, np.asarray(scales, np.float32)


def _to_plane_format(qs: list[np.ndarray], zs: list[np.ndarray], ss: list[np.ndarray]) -> QuantizedLinear:
    """Stack per-layer (q, z, s) into nibble planes: rows [0, In/2) in low
    nibbles, [In/2, In) in high ones."""
    q = np.stack(qs)  # [L, In, Out] u8
    L, In, Out = q.shape
    packed = (q[:, : In // 2] | (q[:, In // 2 :] << 4)).astype(np.uint8)
    s = np.stack(ss)  # [L, G, Out]
    z = np.stack(zs)
    group_size = In // s.shape[1]
    if (In // 2) % group_size:
        raise ValueError(
            f"group_size {group_size} must divide In/2 = {In // 2} "
            "(nibble planes split the IN dim in half)"
        )
    return QuantizedLinear(
        q=torch.from_numpy(packed),
        s=torch.from_numpy(s).to(torch.bfloat16),
        z=torch.from_numpy(z).to(torch.bfloat16),
        group_size=group_size,
    )


# suffix of the HF module path -> the stacked-layer target name
_HF_QUANT_MAP = {
    "self_attn.q_proj": "wq",
    "self_attn.k_proj": "wk",
    "self_attn.v_proj": "wv",
    "self_attn.o_proj": "wo",
    "mlp.gate_proj": "gate",
    "mlp.up_proj": "up",
    "mlp.down_proj": "down",
}
_QUANT_SUFFIXES = ("qweight", "qzeros", "scales", "g_idx", "qweight_scale")


def split_quant_tensors(state: dict[str, Any]):
    """Partition a flat HF state dict into (plain, quant) tensor dicts."""
    plain, quant = {}, {}
    for name, w in state.items():
        if name.rsplit(".", 1)[-1] in _QUANT_SUFFIXES:
            quant[name] = w
        else:
            plain[name] = w
    return plain, quant


def convert_quantized_layers(
    quant: dict[str, Any], num_layers: int, method: str, *, gptq_v2: bool = False
) -> dict[str, QuantizedLinear]:
    """``layers_q`` (a stacked ``QuantizedLinear`` per target) from the
    quantized tensors of an AutoAWQ / AutoGPTQ checkpoint."""
    if method not in ("awq", "gptq"):
        raise ValueError(f"unknown checkpoint method {method!r}")
    per_target: dict[str, dict[int, tuple]] = {t: {} for t in QUANT_TARGETS}
    mods = sorted(name[: -len(".qweight")] for name in quant if name.endswith(".qweight"))
    for mod in mods:
        idx_s, sub = mod[len("model.layers.") :].split(".", 1)
        qw, qz, sc = (
            np.asarray(quant[f"{mod}.qweight"]),
            np.asarray(quant[f"{mod}.qzeros"]),
            np.asarray(quant[f"{mod}.scales"], np.float32),
        )
        if method == "awq":
            q, z, s = unpack_awq(qw, qz, sc)
        else:
            g_idx = quant.get(f"{mod}.g_idx")
            q, z, s = unpack_gptq(
                qw, qz, sc, v2=gptq_v2, g_idx=None if g_idx is None else np.asarray(g_idx)
            )
        per_target[_HF_QUANT_MAP[sub]][int(idx_s)] = (q, z, s)

    layers_q = {}
    for tgt, by_layer in per_target.items():
        if not by_layer:
            continue
        if sorted(by_layer) != list(range(num_layers)):
            raise ValueError(f"missing quantized layers for {tgt}")
        layers_q[tgt] = _to_plane_format(
            [by_layer[i][0] for i in range(num_layers)],
            [by_layer[i][1] for i in range(num_layers)],
            [by_layer[i][2] for i in range(num_layers)],
        )
    return layers_q
