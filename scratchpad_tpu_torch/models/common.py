"""Shared building blocks for the port's models.

Counterpart of ``scratchpad_tpu/models/common.py``: the 4-bit linear layer,
RMSNorm, SiLU-and-mul and rotary embeddings. ``compute_inv_freq`` and
``rope_attention_scale`` are host-side numpy, copied unchanged so both
packages bake identical frequencies (``tests/test_rope.py`` holds the JAX
copy to HF).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from scratchpad_tpu_torch.ops.quant.w4_matmul import (
    check_w4_shape,
    padded_in,
    quantize_rows_int8,
    w4a8_matmul,
    w4a16_matmul,
)


class QuantLinear(nn.Module):
    """A 4-bit group-quantized linear layer in the port's packed layout.

    Counterpart of the JAX package's ``make_quant_matmul`` (W4A16) and
    ``make_w4a8_quant_matmul`` (W4A8): ``a8`` picks the route, per-token
    int8 activations (``quantize_rows_int8`` then ``w4a8_matmul``) or bf16
    activations (``w4a16_matmul``). Buffers ``q``, ``s``, ``z`` (z holds the
    zero points minus 8; see ``ops/quant/w4_matmul.py``), stored ``N``
    columns wide, of which ``out_features`` are real. A shape or device
    that the kernels do not take is refused here, at load."""

    def __init__(
        self,
        in_features: int,
        out_features: int,
        group_size: int,
        stored_width: int,
        a8: bool,
        bias: bool,
        device,
        dtype,
    ):
        super().__init__()
        check_w4_shape(in_features, group_size)
        if torch.device(device).type == "cuda" and dtype != torch.bfloat16:
            raise ValueError(f"the W4 kernels take bf16 activations, not {dtype}")
        self.in_features, self.out_features = in_features, out_features
        self.group_size, self.a8 = group_size, a8
        G = in_features // group_size
        self.register_buffer(
            "q", torch.zeros(stored_width, padded_in(in_features) // 2, dtype=torch.uint8, device=device)
        )
        self.register_buffer("s", torch.zeros(G, stored_width, dtype=torch.bfloat16, device=device))
        self.register_buffer("z", torch.zeros(G, stored_width, dtype=torch.bfloat16, device=device))
        self.bias = (
            nn.Parameter(torch.zeros(out_features, device=device, dtype=dtype)) if bias else None
        )

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        # an imported checkpoint may carry another group size or stored
        # width than quantize_stacked's: take the state's shapes
        s = state_dict.get(prefix + "s")
        if s is not None and s.shape != self.s.shape:
            G, N = s.shape
            if self.in_features % G or N < self.out_features:
                raise ValueError(
                    f"{prefix}s {tuple(s.shape)} does not fit [{self.in_features} -> "
                    f"{self.out_features}]"
                )
            check_w4_shape(self.in_features, self.in_features // G)
            self.group_size = self.in_features // G
            self.q = self.q.new_zeros(N, self.q.shape[1])
            self.s = self.s.new_zeros(G, N)
            self.z = self.z.new_zeros(G, N)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        g, n = self.group_size, self.out_features
        if self.a8:
            x8, ax, gsum = quantize_rows_int8(x, g)
            y = w4a8_matmul(x8, ax, gsum, self.q, self.s, self.z, g, n)
        else:
            y = w4a16_matmul(x, self.q, self.s, self.z, g, n)
        y = y.to(x.dtype)  # the plain versions return f32
        return y if self.bias is None else y + self.bias


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm in f32, cast back to the input dtype."""
    dtype = x.dtype
    xf = x.float()
    xf = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)
    return (xf * weight.float()).to(dtype)


def silu_mul(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return F.silu(gate) * up


def compute_inv_freq(cfg) -> np.ndarray:
    """Rotary inverse frequencies incl. Llama-3 scaling.

    Host-side (numpy) precompute, copied from the JAX package; scaling is
    baked into inv_freq and rope is applied on the fly in the forward.
    """
    head_dim = cfg.head_dim
    inv_freq = 1.0 / (
        cfg.rope_theta ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim)
    )
    rs = cfg.rope_scaling
    if rs:
        rope_type = rs.get("rope_type", rs.get("type", "default"))
        if rope_type == "llama3":
            factor = rs["factor"]
            low = rs["low_freq_factor"]
            high = rs["high_freq_factor"]
            orig = rs["original_max_position_embeddings"]
            wavelen = 2 * np.pi / inv_freq
            # three bands: scale long wavelengths, keep short, smooth between
            smooth = (orig / wavelen - low) / (high - low)
            smooth = np.clip(smooth, 0.0, 1.0)
            scaled = inv_freq / factor
            blended = (1 - smooth) * scaled + smooth * inv_freq
            inv_freq = np.where(wavelen > orig / low, scaled, inv_freq)
            mid = (wavelen <= orig / low) & (wavelen >= orig / high)
            inv_freq = np.where(mid, blended, inv_freq)
        elif rope_type in ("linear",):
            inv_freq = inv_freq / rs["factor"]
        elif rope_type == "yarn":
            # YaRN (public recipe, as in HF modeling_rope_utils):
            # interpolate low-frequency dims by `factor`, keep high-frequency
            # dims, linear-ramp between correction dims set by beta_fast/slow
            factor = rs["factor"]
            orig = rs.get(
                "original_max_position_embeddings",
                getattr(cfg, "max_position_embeddings", 4096),
            )
            beta_fast = rs.get("beta_fast", 32.0)
            beta_slow = rs.get("beta_slow", 1.0)
            dim, base = head_dim, cfg.rope_theta

            def corr_dim(rot):
                return (dim * np.log(orig / (rot * 2 * np.pi))) / (
                    2 * np.log(base)
                )

            low = max(int(np.floor(corr_dim(beta_fast))), 0)
            high = min(int(np.ceil(corr_dim(beta_slow))), dim - 1)
            ramp = np.clip(
                (np.arange(dim // 2, dtype=np.float64) - low)
                / max(high - low, 0.001),
                0.0,
                1.0,
            )
            extrap_mask = 1.0 - ramp  # 1 = keep original (high freq)
            inv_freq = (inv_freq / factor) * (
                1 - extrap_mask
            ) + inv_freq * extrap_mask
        elif rope_type == "longrope":
            # Phi-3 longrope: per-dim rescale factors; the long list applies
            # when the deployed context exceeds the original pretraining one
            orig = rs.get(
                "original_max_position_embeddings",
                cfg.max_position_embeddings,
            )
            use_long = cfg.max_position_embeddings > orig
            ext = np.asarray(
                rs["long_factor"] if use_long else rs["short_factor"],
                np.float64,
            )
            inv_freq = inv_freq / ext
        elif rope_type in ("default", "dynamic", "mrope"):
            # dynamic recomputation not needed: serving contexts are bounded
            # by max_position_embeddings at startup
            pass
    return inv_freq.astype(np.float32)


def rope_attention_scale(cfg) -> float:
    """Extra attention-logit multiplier some rope scalings require.

    YaRN scales cos/sin by mscale = 0.1*ln(factor)+1 (applied to BOTH q and
    k in HF, i.e. logits scale by mscale^2); folding it into sm_scale is
    equivalent and free. longrope similarly uses
    sqrt(1 + ln(factor)/ln(orig)). Default 1.0."""
    rs = cfg.rope_scaling
    if not rs:
        return 1.0
    rope_type = rs.get("rope_type", rs.get("type", "default"))
    if rope_type == "yarn":
        if rs.get("attention_factor") is not None:
            return float(rs["attention_factor"]) ** 2
        return float(0.1 * np.log(rs["factor"]) + 1.0) ** 2
    if rope_type == "longrope":
        orig = rs.get(
            "original_max_position_embeddings", cfg.max_position_embeddings
        )
        factor = cfg.max_position_embeddings / max(orig, 1)
        if factor <= 1.0:
            return 1.0
        return 1.0 + np.log(factor) / np.log(orig)
    return 1.0


def rope_cos_sin(
    positions: torch.Tensor,  # [T]
    inv_freq: torch.Tensor,  # f32[D/2]
) -> tuple[torch.Tensor, torch.Tensor]:
    """f32 [T, 1, D/2] cos and sin tables; computed once per forward and
    shared by every layer."""
    angles = positions.float()[:, None] * inv_freq[None, :]
    return torch.cos(angles)[:, None, :], torch.sin(angles)[:, None, :]


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Non-interleaved (rotate_half) rope, HF Llama convention; x [T, H, D]."""
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
