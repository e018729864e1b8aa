"""Group-quantized 4-bit weights: the JAX package's storage, copied.

Counterpart of ``scratchpad_tpu/ops/quant/w4a16.py``. The quantization runs in
host numpy and is a verbatim copy of the JAX package's (``quantize_w4``,
``quantize_stacked``, ``quantize_model_params``), so both packages produce the
same codes, bit for bit. Its result keeps the JAX storage ("nibble planes"):
a weight W[In, Out] is

    q : uint8 [..., In/2, Out]   low nibble  = rows [0, In/2)
                                 high nibble = rows [In/2, In)
    s : bf16  [..., In/group, Out]  per-(group, out) scales
    z : bf16  [..., In/group, Out]  per-(group, out) zero points (quant units)

with unsigned 4-bit values, w = (nibble - z) * s. Scales and zeros are
rounded to bf16 as the JAX package's default ``dtype=jnp.bfloat16`` does,
even in f32 runs. The kernels read another layout: ``w4_matmul.pack_w4``
repacks these planes into it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class QuantizedLinear:
    """One (possibly layer-stacked) quantized weight in nibble planes."""

    q: torch.Tensor  # uint8 [..., In/2, Out]
    s: torch.Tensor  # bf16 [..., In/group, Out]
    z: torch.Tensor  # bf16 [..., In/group, Out]
    group_size: int = 128
    # true output width when Out was padded up to a 128 multiple (GPT-OSS
    # hidden 2880 -> stored 2944); 0 = unpadded
    out_true: int = 0

    @property
    def in_features(self) -> int:
        return self.q.shape[-2] * 2

    @property
    def out_features(self) -> int:
        return self.out_true or self.q.shape[-1]


def _bf16(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(torch.bfloat16)


def quantize_w4(w: np.ndarray, group_size: int = 128) -> QuantizedLinear:
    """Asymmetric per-group 4-bit quantization of W[In, Out] (host-side)."""
    w = np.asarray(w, np.float32)
    In, Out = w.shape
    assert In % (2 * group_size) == 0 or (In % 2 == 0 and (In // 2) % group_size == 0), (
        f"In={In} not compatible with group={group_size}"
    )
    G = In // group_size
    wg = w.reshape(G, group_size, Out)
    wmin = wg.min(axis=1)  # [G, Out]
    wmax = wg.max(axis=1)
    scale = np.maximum((wmax - wmin) / 15.0, 1e-8)
    zero = np.round(-wmin / scale)  # in quant units, [0, 15]
    q = np.clip(np.round(wg / scale[:, None, :]) + zero[:, None, :], 0, 15)
    q = q.reshape(In, Out).astype(np.uint8)
    lo, hi = q[: In // 2], q[In // 2 :]
    packed = (lo | (hi << 4)).astype(np.uint8)
    return QuantizedLinear(
        q=torch.from_numpy(packed), s=_bf16(scale), z=_bf16(zero), group_size=group_size
    )


def stacked_group_size(In: int, group_size: int = 128) -> int:
    """The group ``quantize_stacked`` picks: the largest g <= group_size
    that divides the nibble-plane height In/2 (GPT-OSS hidden 2880 -> half
    1440 -> g 120)."""
    g = min(group_size, In // 2)
    while (In // 2) % g:
        g -= 1
    return g


def stacked_out_width(Out: int) -> tuple[int, int]:
    """(stored width, out_true) of ``quantize_stacked``: Out above 128 is
    padded up to a multiple of 128."""
    pad = (-Out) % 128
    if pad and Out > 128:
        return Out + pad, Out
    return Out, 0


def quantize_stacked(w_stacked, group_size: int = 128) -> QuantizedLinear:
    """Quantize a layer-stacked weight [L, In, Out], one layer at a time.

    Expert-stacked weights [L, E, In, Out] flatten (layer, expert) onto the
    leading axis, as in the JAX package."""
    w = np.asarray(w_stacked)  # keep the source dtype: NO whole-array f32
    if w.ndim == 4:
        w = w.reshape(-1, *w.shape[2:])
    L, In, Out = w.shape
    g = stacked_group_size(In, group_size)
    G = In // g
    packed = np.empty((L, In // 2, Out), np.uint8)
    scale = np.empty((L, G, Out), np.float32)
    zero = np.empty((L, G, Out), np.float32)
    for l in range(L):
        wl = np.asarray(w[l], np.float32).reshape(G, g, Out)
        wmin = wl.min(axis=1)  # [G, Out]
        wmax = wl.max(axis=1)
        sc = np.maximum((wmax - wmin) / 15.0, 1e-8)
        ze = np.round(-wmin / sc)
        q = np.clip(
            np.round(wl / sc[:, None, :]) + ze[:, None, :], 0, 15
        ).astype(np.uint8).reshape(In, Out)
        packed[l] = q[: In // 2] | (q[In // 2 :] << 4)
        scale[l] = sc
        zero[l] = ze
    stored, out_true = stacked_out_width(Out)
    if out_true:
        # padded columns dequantize to exactly zero; callers slice them off
        pad = stored - Out
        packed = np.pad(packed, ((0, 0), (0, 0), (0, pad)))
        scale = np.pad(scale, ((0, 0), (0, 0), (0, pad)), constant_values=1.0)
        zero = np.pad(zero, ((0, 0), (0, 0), (0, pad)))
    return QuantizedLinear(
        q=torch.from_numpy(packed), s=_bf16(scale), z=_bf16(zero),
        group_size=g, out_true=out_true,
    )


def concat_out(a: QuantizedLinear, b: QuantizedLinear) -> QuantizedLinear:
    """[a | b] along Out: quantization runs along In, so each column keeps
    its codes, scale and zero. Padded stacks cannot be joined."""
    if a.out_true or b.out_true or a.group_size != b.group_size:
        raise ValueError("only unpadded stacks of one group size concatenate along Out")
    return QuantizedLinear(
        q=torch.cat([a.q, b.q], dim=-1), s=torch.cat([a.s, b.s], dim=-1),
        z=torch.cat([a.z, b.z], dim=-1), group_size=a.group_size,
    )


QUANT_TARGETS = ("wq", "wk", "wv", "wo", "gate", "up", "down")


def quantize_model_params(
    layers: dict, group_size: int = 128, fuse_gate_up: bool = False
) -> dict[str, QuantizedLinear]:
    """The quantized stacks of a dict of ``[L, In, Out]`` numpy stacks, by
    target name, as ``params["layers_q"]`` of the JAX package's function.
    ``fuse_gate_up`` concatenates gate|up along Out into one stack,
    ``gate_up_f``: quantization runs along In, so each column's codes are
    those of quantizing gate and up apart."""
    layers = dict(layers)
    layers_q = {}
    if fuse_gate_up and "gate" in layers and "up" in layers:
        g = np.asarray(layers.pop("gate"))
        u = np.asarray(layers.pop("up"))
        layers_q["gate_up_f"] = quantize_stacked(np.concatenate([g, u], axis=-1), group_size)
    for t in QUANT_TARGETS:
        if t in layers:
            layers_q[t] = quantize_stacked(layers.pop(t), group_size)
    return layers_q
