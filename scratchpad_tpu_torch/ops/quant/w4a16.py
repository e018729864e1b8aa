"""Group-quantized 4-bit weights: the JAX package's storage, copied.

Counterpart of ``scratchpad_tpu/ops/quant/w4a16.py``. The quantization is a
verbatim copy of the JAX package's (``quantize_w4``, ``quantize_stacked``,
``quantize_model_params``), so both packages produce the same codes, bit for
bit. ``quantize_stacked`` runs in torch on the weights' own device: every
step is a min, a max, an IEEE f32 division, a round half to even or a
clip, which give the JAX package's numpy bits on the CPU and on the card,
so the engines quantize their weights where they lie. Its result keeps
the JAX storage ("nibble planes"): a weight W[In, Out] is

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
    """Quantize a layer-stacked weight [L, In, Out] (a tensor, on its own
    device; numpy on the CPU), one layer at a time; the codes are the JAX
    package's.

    Expert-stacked weights [L, E, In, Out] flatten (layer, expert) onto the
    leading axis, as in the JAX package."""
    w = w_stacked if torch.is_tensor(w_stacked) else torch.from_numpy(np.asarray(w_stacked, np.float32))
    if w.dim() == 4:
        w = w.reshape(-1, *w.shape[2:])
    L, In, Out = w.shape
    g = stacked_group_size(In, group_size)
    G = In // g
    packed = torch.empty((L, In // 2, Out), dtype=torch.uint8, device=w.device)
    scale = torch.empty((L, G, Out), dtype=torch.float32, device=w.device)
    zero = torch.empty_like(scale)
    for l in range(L):
        wl = w[l].float().reshape(G, g, Out)
        wmin, wmax = wl.amin(dim=1), wl.amax(dim=1)
        # a tensor divisor: CUDA divides by a host scalar through its reciprocal
        sc = torch.clamp_min((wmax - wmin) / torch.full_like(wmax, 15.0), 1e-8)
        ze = torch.round(-wmin / sc)
        q = torch.clamp(torch.round(wl / sc[:, None, :]) + ze[:, None, :], 0, 15)
        q = q.to(torch.uint8).reshape(In, Out)
        packed[l] = q[: In // 2] | (q[In // 2 :] << 4)
        scale[l], zero[l] = sc, ze
    stored, out_true = stacked_out_width(Out)
    if out_true:  # padded columns dequantize to exactly zero; callers slice them off
        pad = stored - Out
        packed = torch.nn.functional.pad(packed, (0, pad))
        scale = torch.nn.functional.pad(scale, (0, pad), value=1.0)
        zero = torch.nn.functional.pad(zero, (0, pad))
    return QuantizedLinear(
        q=packed, s=scale.to(torch.bfloat16), z=zero.to(torch.bfloat16), group_size=g,
        out_true=out_true,
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


QUANT_TARGETS = (
    "wq", "wk", "wv", "wo", "gate", "up", "down",
    # MoE expert stacks [L, E, In, Out] (flattened to L*E on the lead axis;
    # "down" doubles as GPT-OSS's 4-D expert down projection)
    "w1", "w2", "w3", "gate_up",
)


def quantize_model_params(
    layers: dict, group_size: int = 128, fuse_gate_up: bool = False
) -> dict[str, QuantizedLinear]:
    """The quantized stacks of a dict of ``[L, In, Out]`` stacks (numpy, or
    tensors quantized on their device), by target name, as ``params["layers_q"]`` of the JAX package's function.
    ``fuse_gate_up`` concatenates gate|up along Out into one stack,
    ``gate_up_f``: quantization runs along In, so each column's codes are
    those of quantizing gate and up apart."""
    layers = dict(layers)
    layers_q = {}
    if fuse_gate_up and "gate" in layers and "up" in layers:
        g, u = (torch.as_tensor(layers.pop(t)) for t in ("gate", "up"))
        layers_q["gate_up_f"] = quantize_stacked(torch.cat([g, u], dim=-1), group_size)
    for t in QUANT_TARGETS:
        if t in layers:
            layers_q[t] = quantize_stacked(layers.pop(t), group_size)
    return layers_q
