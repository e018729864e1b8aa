"""Batched multi-adapter (LoRA and int8 delta) matmuls of the toppings path.

Counterpart of ``scratchpad_tpu/ops/ldmm.py``.

- rank-r LoRA (``lora_grouped``): the active adapters' factors ride two
  batched contractions with each token's slot one-hot (times the adapter's
  scaling) folded into the rank-r intermediate. The JAX package leaves them
  to XLA; here they are plain PyTorch.

- full-rank int8 deltas: the JAX package launches its Pallas kernel
  ``_delta_kernel`` once per active slot, and each launch writes its slot's
  rows and zeros elsewhere. ``delta_matmul_grouped`` launches one CUDA kernel
  (``csrc/delta_matmul.cu``) per projection for every slot, which adds each
  delta slot's product to that slot's rows of the projection's output, in
  place, and leaves every other row as it is. ``delta_matmul_plain`` is the
  JAX per-slot function (``delta_matmul_xla``) in f32, and
  ``delta_matmul_grouped_plain`` the grouped one built from it: the CPU path
  and the kernel's oracle. The kernel runs on the Hopper GEMM mainloop
  (``csrc/sm90_gemm.cuh``) with ``w4_matmul.gemm_plan``'s tile and K split
  for its ``S - 1`` slots, and a split-K workspace kept per device.
"""

from __future__ import annotations

import ctypes

import torch

from scratchpad_tpu_torch.ops.quant.w4_matmul import GEMM_CUT, gemm_plan, workspace
from scratchpad_tpu_torch.utils import native

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "delta_matmul_grouped": ([_P] * 8 + [_I] * 7 + [_P, _P, _I, _I], ctypes.c_int),
}
K_STEP = 16  # the kernel's k-step: In must be a multiple
OUT_ALIGN = 8  # the panel's rows are copied in 8- or 16-byte pieces


def lora_grouped(
    x: torch.Tensor,  # [T, In]
    A_act: torch.Tensor,  # [S-1, In, r] active adapters' A (slot 0 dropped)
    B_act: torch.Tensor,  # [S-1, r, Out]
    slot_scale: torch.Tensor,  # f32[T, S-1] one-hot(slot) * scaling
) -> torch.Tensor:
    """sum_s ((x (*) mask_s) @ A_s) @ B_s as two batched contractions, each
    in f32 and rounded to x's dtype where the JAX function rounds."""
    u = torch.einsum("ti,sir->tsr", x.float(), A_act.float())
    u = (u * slot_scale[:, :, None]).to(x.dtype)
    return torch.einsum("tsr,sro->to", u.float(), B_act.float()).to(x.dtype)


def delta_matmul_plain(x, dq, ds, aid, layer, mask_scale) -> torch.Tensor:
    """f32 ``((x * mask_scale) @ dq[aid, layer]) * ds[aid, layer]``: one
    slot's product, the math of ``delta_matmul_xla`` (``ops/ldmm.py:130``)."""
    dw = dq[aid, layer].float()  # int8 codes: exact in f32
    xm = x.float() * mask_scale[:, None].float()
    return (xm @ dw) * ds[aid, layer].float()


def delta_matmul_grouped_plain(
    out, x, dq, ds, layer, active_adapters, has_delta, scaling, token_slot
) -> torch.Tensor:
    """``out`` with each delta slot's product added to that slot's rows in
    f32 and rounded once to ``out``'s dtype, in place; every other row is
    left as it is, bit for bit. Slot j's pool adapter is
    ``active_adapters[j]``; it has a delta where ``has_delta`` says so."""
    for j in range(1, active_adapters.shape[0]):
        aid = active_adapters[j].long()
        aid_eff = aid * has_delta[aid]
        rows = (token_slot == j) & (aid_eff > 0)
        y = delta_matmul_plain(x, dq, ds, aid_eff, layer, rows.float() * scaling[aid])
        out.copy_(torch.where(rows[:, None], (out.float() + y).to(out.dtype), out))
    return out


def _check(name, t, dtype, shape, align=4) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {list(shape)}, got {list(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % align:
        raise ValueError(f"{name} must be contiguous and {align}-byte aligned")


def _delta_launch(lib, out, x, dq, ds, layer, active_adapters, has_delta, scaling, token_slot):
    T, In = x.shape
    N, L, _, Out = dq.shape
    S = active_adapters.shape[0]
    if In % K_STEP:
        raise ValueError(f"In {In} must be a multiple of {K_STEP}")
    if Out % OUT_ALIGN:
        raise ValueError(f"Out {Out} must be a multiple of {OUT_ALIGN}")
    if not 0 <= layer < L:
        raise ValueError(f"layer {layer} not in 0..{L - 1}")
    _check("x", x, torch.bfloat16, (T, In), align=16)
    _check("out", out, torch.bfloat16, (T, Out))
    _check("dq", dq, torch.int8, (N, L, In, Out), align=16)
    _check("ds", ds, torch.float32, (N, L, Out))
    _check("active_adapters", active_adapters, torch.int32, (S,))
    _check("has_delta", has_delta, torch.int32, (N,))
    _check("scaling", scaling, torch.float32, (N,))
    _check("token_slot", token_slot, torch.int32, (T,))
    plan = gemm_plan(T, Out, In, slots=max(S - 1, 1))
    ws = workspace("delta_matmul_grouped", out.device)
    rc = lib.delta_matmul_grouped(
        x.data_ptr(), out.data_ptr(), dq.data_ptr(), ds.data_ptr(),
        active_adapters.data_ptr(), has_delta.data_ptr(), scaling.data_ptr(),
        token_slot.data_ptr(), T, In, Out, N, L, S, layer, native.stream_handle(out.device),
        ws.data_ptr(), plan.config, plan.splits,
    )
    if rc != 0:
        raise RuntimeError(f"delta_matmul_grouped launch failed: cudaError {rc}")
    return out


def delta_matmul_grouped(
    out: torch.Tensor,  # [T, Out], the projection's fresh output
    x: torch.Tensor,  # [T, In]
    dq: torch.Tensor,  # i8[N, L, In, Out]
    ds: torch.Tensor,  # f32[N, L, Out]
    layer: int,
    active_adapters: torch.Tensor,  # i32[S]
    has_delta: torch.Tensor,  # i32[N]
    scaling: torch.Tensor,  # f32[N]
    token_slot: torch.Tensor,  # i32[T]
) -> torch.Tensor:
    """Add every delta slot's ``(x @ dq[aid, layer]) * ds[aid, layer] *
    scaling[aid]`` to its rows of ``out`` in place and return ``out``
    (``delta_matmul_grouped_plain`` for CPU tensors; ``csrc/delta_matmul.cu``
    for CUDA tensors, bf16 ``x`` and ``out``, In a multiple of 16 and Out of
    8). The caller hands in a tensor that nothing else holds: the
    projection's output under ``inference_mode``. The kernel reads the
    slots, flags and scalings on the device and never brings them to the
    host."""
    native.check_same_device(out, x, dq, ds, active_adapters, has_delta, scaling, token_slot)
    args = (out, x, dq, ds, layer, active_adapters, has_delta, scaling, token_slot)
    if out.device.type == "cpu":
        return delta_matmul_grouped_plain(*args)
    if out.device.type != "cuda":
        raise ValueError(f"delta_matmul_grouped: unsupported device {out.device}")
    _delta_launch(native.load("delta_matmul", _SIGNATURES), *args)
    delta_matmul_grouped.launches += 1
    return out


delta_matmul_grouped.launches = 0


def delta_matmul_grouped_cut(out, x, dq, ds, layer, active_adapters, has_delta, scaling,
                             token_slot) -> torch.Tensor:
    """The kernel built with ``GEMM_CUT``, for timing only: it loads and
    converts the panels and takes no product (``out`` is left as it was).
    Card only."""
    native.check_same_device(out, x, dq, ds, active_adapters, has_delta, scaling, token_slot)
    if out.device.type != "cuda":
        raise ValueError("delta_matmul_grouped_cut runs on the card only")
    _delta_launch(native.load("delta_matmul", _SIGNATURES, GEMM_CUT), out, x, dq, ds, layer,
                  active_adapters, has_delta, scaling, token_slot)
    return out

