"""Shared building blocks for the port's models.

Counterpart of ``scratchpad_tpu/models/common.py``: the 4-bit linear layer,
the one place where a dense weight becomes quantized buffers
(``quantize_weight``) and a tensor-parallel rank's quantized load
(``place_whole``), tensor parallelism's row-parallel sum (``row_parallel_sum``), its
vocabulary-parallel embedding and head (``vocab_lookup``, ``vocab_logits``)
and its seeded random fill (``fill_random``: a rank keeps its shard of
each single-device draw), RMSNorm,
SiLU-and-mul, GELU-and-mul and rotary embeddings (half-split and
interleaved pairs) and multimodal rope (``apply_mrope``). ``compute_inv_freq``, ``rope_attention_scale`` and
DeepSeek's YaRN multiplier (``deepseek_yarn_scale``) are host-side numpy,
copied unchanged so both packages bake identical frequencies
(``tests/test_rope.py`` holds the JAX copy to HF).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from scratchpad_tpu_torch.ops.quant.fp8 import quantize_fp8_stacked
from scratchpad_tpu_torch.ops.quant.w4_matmul import (
    check_w4_shape,
    pack_w4,
    padded_in,
    quantize_rows_int8,
    row_amax,
    w4a8_matmul,
    w4a16_matmul,
)
from scratchpad_tpu_torch.ops.quant.w4a16 import quantize_stacked


class QuantLinear(nn.Module):
    """A 4-bit group-quantized linear layer in the port's packed layout.

    Counterpart of the JAX package's ``make_quant_matmul`` (W4A16) and
    ``make_w4a8_quant_matmul`` (W4A8): ``a8`` picks the route, per-token
    int8 activations (``quantize_rows_int8`` then ``w4a8_matmul``) or bf16
    activations (``w4a16_matmul``). Buffers ``q``, ``s``, ``z`` (z holds the
    zero points in bf16; see ``ops/quant/w4_matmul.py``), stored ``N``
    columns wide, of which ``out_features`` are real. A shape or device
    that the kernels do not take is refused here, at load.

    ``tp``: the tensor-parallel group of a row-parallel layer, whose input
    is a rank's slice of the whole row (``in_features`` of it). W4A8 then
    quantizes the slice with the whole row's scale, as the single device
    does: the slice's row maxima, their maximum over the group (one
    collective), then the quantizer with it (``partial``). Its output is the
    rank's partial product; the caller sums it over the group."""

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
        tp=None,
    ):
        super().__init__()
        check_w4_shape(in_features, group_size)
        if torch.device(device).type == "cuda" and dtype != torch.bfloat16:
            raise ValueError(f"the W4 kernels take bf16 activations, not {dtype}")
        self.in_features, self.out_features = in_features, out_features
        self.group_size, self.a8, self.tp = group_size, a8, tp
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

    def partial(self, x: torch.Tensor, amax=None) -> torch.Tensor:
        """The product of ``x`` without the bias, in ``x``'s dtype; a
        row-parallel W4A8 layer's in f32, a rank's partial product, which
        the group sums before its one rounding (``row_parallel``). W4A8
        quantizes each row with ``amax`` (f32 [M, 1]) where given, else
        with its own maximum, taken over the group where the layer is
        row-parallel."""
        g, n = self.group_size, self.out_features
        if self.a8:
            if amax is None and self.tp is not None:
                amax = self.tp.all_reduce(row_amax(x), op="max")
            x8, ax, gsum = quantize_rows_int8(x, g, amax)
            y = w4a8_matmul(x8, ax, gsum, self.q, self.s, self.z, g, n, f32=self.tp is not None)
            if self.tp is not None:
                return y.float()  # the plain version's is f32 already
        else:
            y = w4a16_matmul(x, self.q, self.s, self.z, g, n)
        return y.to(x.dtype)  # the plain versions return f32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.partial(x)
        return y if self.bias is None else y + self.bias


def quantize_weight(prefix: str, w: torch.Tensor, quantization: str) -> tuple[dict, int]:
    """The buffers of the quantized module ``prefix`` made from its whole
    dense weight ``w`` ``[In, Out]`` on ``w``'s device, the JAX package's
    codes bit for bit: fp8's ``w8`` and ``s`` (``quantize_fp8_stacked``),
    a 4-bit route's packed ``q``, ``s`` and ``z`` (``quantize_stacked``,
    ``pack_w4``; Llama's fused gate|up is the weight ``[In, 2I]``, as
    ``quantize_model_params(fuse_gate_up=True)`` fuses it). Also the real
    columns of a padded 4-bit stored width (0 where none is, and for fp8),
    which a column cut needs. ``quantize_state`` keeps the buffers whole, a
    tensor-parallel rank's ``place_whole`` its cut of them."""
    if quantization == "fp8":
        codes, scales = quantize_fp8_stacked(w[None])
        return {f"{prefix}.w8": codes[0], f"{prefix}.s": scales[0]}, 0
    ql = quantize_stacked(w[None])
    return {f"{prefix}.{part}": t[0] for part, t in zip("qsz", pack_w4(ql))}, ql.out_true


def state_tensor(module: nn.Module, name: str) -> torch.Tensor:
    """``module``'s parameter or buffer ``name``."""
    try:
        return module.get_parameter(name)
    except AttributeError:
        return module.get_buffer(name)


@torch.no_grad()
def place_whole(model: nn.Module, name: str, whole: torch.Tensor, pending: dict, expert=None) -> None:
    """Load the whole single-device tensor ``name`` (a ``state_dict`` name
    of the unquantized twin; an expert stack's expert ``expert``, or the
    whole stack ``[E, In, Out]`` an expert at a time) into ``model``, a
    quantized tensor-parallel rank's. A weight that the model quantizes
    (the class's ``QUANT_TARGETS`` of a layer, each expert of its
    ``EXPERT_STACKS``) goes through ``quantize_weight`` on the model's
    device in its dtype (``quantize_state``'s codes at tp 1), then the
    rank's cut of each buffer is kept (``cut_w4``, ``cut_fp8``); Llama's
    4-bit gate waits in ``pending`` for up, and the two are quantized as the
    fused gate|up. Any other tensor is copied from the rank's view of it
    (``copy_cut_``). One whole tensor (gate|up: two) is alive at a time.
    The model classes take it as their method."""
    from scratchpad_tpu_torch.parallel import copy_cut_, cut_fp8, cut_w4, split_of

    tp, family = model.tp, model.tp_family
    parts = name.split(".")
    in_layer = parts[0] == "layers"
    stack = in_layer and len(parts) == 3 and parts[2] in getattr(model, "EXPERT_STACKS", ())
    if stack and expert is None:
        for e in range(whole.shape[0]):
            place_whole(model, name, whole[e], pending, e)
        return
    if not (stack or (in_layer and parts[2] in model.QUANT_TARGETS and parts[3:] == ["weight"])):
        copy_cut_(state_tensor(model, name), whole, split_of(name, family), tp.rank, tp.size, name)
        return
    w = whole.to(device=model.final_norm.device, dtype=model.final_norm.dtype)
    w, prefix = (w, name) if stack else (w.T, name[: -len(".weight")])  # [In, Out]
    l = int(parts[1])
    if parts[2] in ("gate", "up") and getattr(model.layers[l], "fused_gate_up", False):
        pending[(l, parts[2])] = w
        if (l, "gate") not in pending or (l, "up") not in pending:
            return
        w, prefix = torch.cat([pending.pop((l, "gate")), pending.pop((l, "up"))], dim=1), f"layers.{l}.gate_up"
    fp8 = model.quantization == "fp8"
    if stack and not fp8:  # a 4-bit expert is a QuantLinear of its own
        prefix, expert = f"{prefix}.{expert}", None
    bufs, out_true = quantize_weight(prefix, w, model.quantization)
    for key, v in bufs.items():
        _, kind, part = split_of(key, family)
        v = (cut_fp8(v, part, kind, tp.rank, tp.size, key) if fp8
             else cut_w4(v, part, kind, tp.rank, tp.size, out_true, key))
        dst = state_tensor(model, key)
        (dst if expert is None else dst[expert]).copy_(v)


def row_parallel_sum(y: torch.Tensor, tp=None) -> torch.Tensor:
    """A row-parallel projection's partial products ``y`` summed over the
    tensor-parallel group ``tp`` (``parallel.TPGroup``; None at tp 1).
    Column-parallel projections need no collective."""
    return y if tp is None else tp.row_sum(y)


def row_parallel(lin: nn.Module, x: torch.Tensor, tp=None) -> torch.Tensor:
    """A row-parallel projection ``lin`` (``nn.Linear``, ``QuantLinear`` or
    ``Fp8Linear``) of the rank's slice ``x``: the rank's partial product
    (a quantized layer's ``partial``: fp8's stays f32), summed over the
    group in f32 and rounded once to ``x``'s dtype, the bias added once,
    after the sum. ``lin(x)`` at tp 1."""
    if tp is None:
        return lin(x)
    y = F.linear(x, lin.weight) if isinstance(lin, nn.Linear) else lin.partial(x)
    y = tp.row_sum(y).to(x.dtype)
    return y if lin.bias is None else y + lin.bias


def vocab_lookup(embed: nn.Embedding, ids: torch.Tensor, tp=None) -> torch.Tensor:
    """The embedding rows of ``ids``; under tensor parallelism (``tp``) each
    rank looks up the ids in its vocabulary range, zero rows elsewhere, and
    the ranks' rows are summed: exact, one rank holds each row."""
    if tp is None:
        return embed(ids)
    rows = embed.num_embeddings
    local = ids - tp.rank * rows
    inside = (local >= 0) & (local < rows)
    x = embed(local.clamp(0, rows - 1))
    return tp.all_reduce(torch.where(inside[:, None], x, torch.zeros_like(x)))


def vocab_logits(h: torch.Tensor, head: torch.Tensor, vocab_size: int, tp=None) -> torch.Tensor:
    """f32 logits of rows ``h`` [N, H] through the head ``head`` [V, H]; under
    tensor parallelism the rank's columns are gathered into every column,
    on every rank, the padded ones dropped."""
    logits = (h @ head.T).float()
    return logits if tp is None else tp.gather_vocab(logits, vocab_size)


def fill_random(w: torch.Tensor, name: str, generator: torch.Generator, tp=None, family: str = "llama",
                vocab_size: int = 0, fan_in_dim: int = -1, place=None) -> None:
    """``w`` (the tensor ``name`` of ``family``'s ``state_dict``, or a rank's
    shard of it) filled with N(0, 1) / sqrt(fan-in), the JAX package's
    scheme, drawn at the single-device shape on the generator's device and
    cut to the rank's shard: every rank of every tensor-parallel size holds
    the tp 1 weights of the same seed. The fan-in is the single-device
    shape's dimension ``fan_in_dim`` (In of an [out, in] weight).
    ``place(name, whole)``: takes the whole draw instead of ``w`` (a model
    on the meta device, whose draws a quantizing load places)."""
    from scratchpad_tpu_torch.parallel import full_shape, shard_tensor

    size, rank = (1, 0) if tp is None else (tp.size, tp.rank)
    shape = tuple(w.shape) if tp is None else full_shape(name, tuple(w.shape), size, vocab_size, family)
    # scaled in place: one f32 copy of the whole tensor alive at a time
    whole = torch.randn(shape, generator=generator, device=generator.device, dtype=torch.float32)
    whole.div_(float(np.sqrt(shape[fan_in_dim])))
    if place is not None:
        place(name, whole)
    else:
        w.copy_(shard_tensor(name, whole, rank, size, family))


def fill_experts(p: torch.Tensor, name: str, generator: torch.Generator, tp=None, family: str = "llama",
                 place=None) -> None:
    """An expert stack ``p`` [E, In, Out] (or a rank's shard) filled as
    ``fill_random`` fills it, one expert at a time (a stack is drawn whole
    nowhere: GPT-OSS-20B's take 38 GB in bf16), each over its fan-in In;
    ``place(name, whole, e)`` takes each expert's whole draw instead."""
    from scratchpad_tpu_torch.parallel import cut, full_shape, split_of

    size, rank = (1, 0) if tp is None else (tp.size, tp.rank)
    E, In, Out = full_shape(name, tuple(p.shape), size, 0, family)
    split = split_of(name, family) if tp is not None else None
    # the stack's split, on one expert [In, Out]
    split = None if split is None else (("halves", 1) if isinstance(split, tuple) else split - 1)
    for e in range(E):
        whole = torch.randn((In, Out), generator=generator, device=generator.device, dtype=torch.float32)
        whole.div_(float(np.sqrt(In)))
        if place is not None:
            place(name, whole, e)
        else:
            p[e].copy_(cut(whole, split, rank, size, name))


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm in f32, cast back to the input dtype."""
    dtype = x.dtype
    xf = x.float()
    xf = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)
    return (xf * weight.float()).to(dtype)


def silu_mul(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return F.silu(gate) * up


def gelu_mul(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """GELU with the tanh approximation, times up (Gemma's MLP)."""
    return F.gelu(gate, approximate="tanh") * up


def compute_inv_freq(cfg) -> np.ndarray:
    """Rotary inverse frequencies incl. Llama-3 scaling.

    Host-side (numpy) precompute, copied from the JAX package; scaling is
    baked into inv_freq and rope is applied on the fly in the forward.
    YaRN also reads ``rope_scaling["truncate"]``, which the JAX copy
    ignores (it always truncates, HF's default).
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

            # the correction range, floored and ceiled unless the config
            # says truncate: false (HF's rule; GPT-OSS's checkpoints say so)
            low, high = corr_dim(beta_fast), corr_dim(beta_slow)
            if rs.get("truncate", True):
                low, high = int(np.floor(low)), int(np.ceil(high))
            low, high = max(low, 0), min(high, dim - 1)
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


def yarn_mscale(scale: float, mscale: float = 1.0) -> float:
    """YaRN's magnitude factor ``0.1 * mscale * ln(scale) + 1`` (1 where
    ``scale <= 1``), HF's ``yarn_get_mscale``."""
    return float(0.1 * mscale * np.log(scale) + 1.0) if scale > 1 else 1.0


def deepseek_yarn_scale(rs) -> float:
    """DeepSeek's YaRN multiplier of the rope dims' cos and sin (HF's
    ``attention_scaling``; JAX ``deepseek.py:47-61``): ``attention_factor``
    where given, else ``mscale(factor, mscale) / mscale(factor,
    mscale_all_dim)`` where both are set, else ``mscale(factor)``; 1 without
    YaRN."""
    if not rs or rs.get("rope_type", rs.get("type")) != "yarn":
        return 1.0
    if rs.get("attention_factor") is not None:
        return float(rs["attention_factor"])
    factor = rs["factor"]
    mscale, mad = rs.get("mscale"), rs.get("mscale_all_dim")
    if mscale and mad:
        return yarn_mscale(factor, mscale) / yarn_mscale(factor, mad)
    return yarn_mscale(factor)


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


def mrope_channel_components(mrope_section: list[int], head_dim: int) -> np.ndarray:
    """Per-channel component index (0 = t, 1 = h, 2 = w) of multimodal rope,
    copied from the JAX package: HF splits the doubled cos/sin (size
    head_dim) into the section list repeated twice and assigns the
    components round-robin, so the pattern has period head_dim / 2 and the
    rotate-half pairs (j, j + head_dim / 2) share a component."""
    comp = np.zeros(head_dim, np.int32)
    o = 0
    for i, s in enumerate(list(mrope_section) * 2):
        comp[o : o + s] = i % 3
        o += s
    assert o == head_dim, (mrope_section, head_dim)
    return comp


def mrope_cos_sin(
    mpos: torch.Tensor,  # i[3, T] (t, h, w) positions
    inv_freq: torch.Tensor,  # f32[D/2]
    comp: torch.Tensor,  # i64[D] channel -> component
) -> tuple[torch.Tensor, torch.Tensor]:
    """``rope_cos_sin``'s tables for multimodal 3-D positions: channel j of
    the half takes the position of its component (the pair j, j + D/2 shares
    it), so ``apply_rope`` with them is the JAX ``apply_mrope``."""
    half = inv_freq.shape[0]
    angles = mpos.float()[comp[:half]].T * inv_freq[None, :]  # [T, D/2]
    return torch.cos(angles)[:, None, :], torch.sin(angles)[:, None, :]


def apply_mrope(x: torch.Tensor, mpos: torch.Tensor, inv_freq: torch.Tensor,
                comp: torch.Tensor) -> torch.Tensor:
    """Multimodal 3-D rope (Qwen2-VL), the JAX ``apply_mrope``; equals
    ``apply_rope`` where the three components are equal (text rows)."""
    return apply_rope(x, *mrope_cos_sin(mpos, inv_freq, comp))


def apply_rope_interleaved(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Interleaved-pair (complex) rope, as the JAX ``apply_rope_interleaved``
    (Llama-4): the pair ``(x[2j], x[2j+1])`` rotates by ``pos * inv_freq[j]``;
    x [T, H, D], ``cos``/``sin`` from ``rope_cos_sin``."""
    xf = x.float()
    x1, x2 = xf[..., 0::2], xf[..., 1::2]
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(x.shape).to(x.dtype)
