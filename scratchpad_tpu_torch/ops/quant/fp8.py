"""fp8 (e4m3) weight-only quantization.

Counterpart of ``scratchpad_tpu/ops/quant/fp8.py`` (BASELINE config 4, "8B
FP8 weights+KV"). Each weight is stored as ``float8_e4m3fn`` codes with one
f32 scale per output channel, ``amax / 448`` floored at 1e-12; the product
upcasts the codes to the activations' dtype, takes the dot with an f32
result, multiplies by the channel scale and rounds once. The JAX package
runs this in XLA, with no Pallas kernel behind it, so the port runs it in
torch: on the card ``torch.mm(..., out_dtype=torch.float32)`` (bf16
operands, an f32 result), on the CPU an f32 product.

The upcast writes and reads a model-dtype copy of each weight on every
call, so an fp8 engine reads more bytes a decode step than a bf16 one until
a weight-only fp8 GEMM reads the codes once (a redesign candidate in
``ROADMAP.md``, Queue 2).
"""

from __future__ import annotations

import torch
from torch import nn

F8 = torch.float8_e4m3fn
F8_MAX = 448.0


def quantize_fp8_stacked(w_stacked) -> tuple[torch.Tensor, torch.Tensor]:
    """(codes e4m3 [L, In, Out], scales f32 [L, Out]) of a stacked weight
    ``[L, In, Out]`` (numpy or a tensor, quantized on the tensor's device),
    the JAX package's codes bit for bit: the channel's ``amax / 448`` floored
    at 1e-12 and ``w / scale`` in f32 (IEEE division on both devices), then
    one cast to e4m3 (round to nearest even; ``|w / scale| <= 448`` up to one
    rounding, which rounds back to 448). Expert stacks ``[L, E, In, Out]``
    flatten (layer, expert) into one leading axis (index ``l * E + e``)."""
    w = torch.as_tensor(w_stacked).float()
    if w.dim() == 4:
        w = w.reshape(-1, *w.shape[2:])
    amax = w.abs().amax(dim=-2, keepdim=True)  # [L, 1, Out]
    # a tensor divisor: CUDA divides by a host scalar through its reciprocal
    scale = torch.clamp_min(amax / torch.full_like(amax, F8_MAX), 1e-12)
    return (w / scale).to(F8), scale[..., 0, :].contiguous()


def matmul_f32(x: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
    """f32 ``x @ w8`` with the codes upcast to ``x``'s dtype: bf16 or f16
    operands with an f32 result on the card, an f32 product otherwise. ``x``
    [T, In] with ``w8`` [In, Out] or [E, In, Out] (every expert), or [E, T,
    In] with [E, In, Out]."""
    w = w8.to(x.dtype)
    if x.dtype == torch.float32:
        return torch.matmul(x, w)
    if x.device.type == "cuda":
        if w.dim() == 2:
            return torch.mm(x, w, out_dtype=torch.float32)
        return torch.bmm(x.expand(w.shape[0], *x.shape[-2:]).contiguous(), w, out_dtype=torch.float32)
    return torch.matmul(x.float(), w.float())


class Fp8Linear(nn.Module):
    """A linear layer over fp8 codes: buffers ``w8`` (e4m3 ``[In, Out]``,
    the JAX orientation) and ``s`` (f32 ``[Out]``), an optional bias in the
    model dtype. ``forward(x)`` is the JAX ``fp8_matmul``: f32 until the
    scale is applied, then one rounding to ``x``'s dtype."""

    def __init__(self, in_features: int, out_features: int, bias: bool, device, dtype):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.register_buffer("w8", torch.zeros(in_features, out_features, dtype=F8, device=device))
        self.register_buffer("s", torch.ones(out_features, dtype=torch.float32, device=device))
        self.bias = (
            nn.Parameter(torch.zeros(out_features, device=device, dtype=dtype)) if bias else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:-1]
        y = (matmul_f32(x.reshape(-1, self.in_features), self.w8) * self.s).to(x.dtype)
        y = y.view(*lead, self.out_features)
        return y if self.bias is None else y + self.bias


class Fp8ExpertStack(nn.Module):
    """E experts' ``[In, Out]`` matrices as fp8 codes ``w8`` [E, In, Out]
    with scales ``s`` [E, Out]: the masked dense experts multiply every
    token by every expert in one batched product, as the bf16 stacks do."""

    def __init__(self, E: int, in_features: int, out_features: int, device):
        super().__init__()
        self.register_buffer("w8", torch.zeros(E, in_features, out_features, dtype=F8, device=device))
        self.register_buffer("s", torch.ones(E, out_features, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[E, T, Out] in ``x``'s dtype for ``x`` [T, In] or [E, T, In]."""
        return (matmul_f32(x, self.w8) * self.s[:, None, :]).to(x.dtype)


def fp8_state(codes: torch.Tensor, scales: torch.Tensor, prefix: str, device) -> dict:
    """``{prefix.w8, prefix.s}`` on ``device``."""
    return {f"{prefix}.w8": codes.to(device), f"{prefix}.s": scales.to(device)}
