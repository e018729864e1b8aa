"""4-bit weight GEMMs: the port's packed layout, the CUDA kernels' wrappers
and their plain versions.

Counterpart of ``scratchpad_tpu/ops/quant/pallas_w4.py``, whose four Pallas
kernels (``_w4a8_kernel_q4``, ``_w4a8_kernel``, ``_w4_kernel_q4``,
``_w4_kernel``) become two hand-written CUDA kernels,
``csrc/w4a8_matmul.cu`` and ``csrc/w4a16_matmul.cu``, each taking every
group size; the per-token int8 quantization of the activations, which the
JAX package leaves to XLA, is a third (``w4_quantize_rows`` in
``w4a8_matmul.cu``).

``gemm_plan`` is the launch plan of the Hopper GEMM mainloop
(``csrc/sm90_gemm.cuh``) that ``w4a16_matmul`` and the delta kernel
(``ops/ldmm.py``) run on: the output tile, the K split and the split-K
workspace, which each wrapper allocates once per device and keeps.

The packed layout, one for every group size. A weight W[In, Out] of
``w4a16.QuantizedLinear`` (nibble planes) is stored as

    q : uint8 [N, Kp/2]  Kp = In rounded up to a multiple of 32. Byte (n, j)
                         holds the code of row 2j in its low nibble and of
                         row 2j + 1 in its high nibble; rows past In hold 0.
                         A code is nibble - 8 in 4-bit two's complement
                         (nibble ^ 8), so it sign-extends to an int8 that
                         the s8 tensor cores take as it is.
    s : bf16 [G, N]      scales, G = In / group_size
    z : bf16 [G, N]      zero points minus 8, so w = (code - z) * s

with N the stored (possibly padded) width. Each output column's codes are
contiguous along In: that is the ``.col`` B operand of ``mma.sync``. The
zero point is never stored as a nibble (GPTQ v1 zeros reach 16).

Each wrapper takes the plain PyTorch version for CPU tensors and launches its
kernel for CUDA tensors, raising on anything the kernel does not take; it
never falls back. ``check_w4_shape`` refuses at load what a kernel would
refuse mid-request.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch
import torch.nn.functional as F

from scratchpad_tpu_torch.ops.quant.w4a16 import QuantizedLinear
from scratchpad_tpu_torch.utils import native

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES_A8 = {
    "w4_quantize_rows": ([_P, _I, _I, _I, _I, _I, _P, _P, _P, _P], ctypes.c_int),
    "w4a8_matmul": ([_P] * 7 + [_I] * 6 + [_P], ctypes.c_int),
}
_SIGNATURES_A16 = {
    "w4a16_matmul": ([_P] * 5 + [_I] * 7 + [_P, _P, _I, _I], ctypes.c_int),
    "w4a16_matmul_mma": ([_P] * 5 + [_I] * 7 + [_P], ctypes.c_int),
}
# the timing cut of csrc/sm90_gemm.cuh: every block loaded and converted, no
# products, nothing written (tools/gemm_ab.py)
GEMM_CUT = {"SPTPU_GEMM_CUT": 1}
K_ALIGN = 32
# the quantizer keeps one int per group in shared memory
MAX_GROUPS = 227 * 1024 // 4


def padded_in(in_features: int) -> int:
    return -(-in_features // K_ALIGN) * K_ALIGN


# ---------------------------------------------------------------- launch plan

SMS = 132  # streaming multiprocessors of one H100 SXM
K_BLOCK = 64  # the mainloop's k block (kKB)
# csrc/sm90_gemm.cuh's tile configurations, by the id its kernels take:
# (rows, columns) of a CTA's output tile
TILE_CONFIGS = {0: (128, 128), 1: (64, 256), 2: (64, 64)}
COUNTER_SLOTS = 4096  # kCounterSlots: i32 split-K counters at the workspace's head
PARTIAL_BYTES = 32 << 20  # the f32 partials a workspace holds
WORKSPACE_BYTES = COUNTER_SLOTS * 4 + PARTIAL_BYTES


@dataclasses.dataclass(frozen=True)
class GemmPlan:
    """One launch of ``sm90_gemm_kernel``: grid ``(n_tiles * splits,
    m_tiles, slots)``; the CTA of split ``i`` takes k blocks
    ``k_range(i)``."""

    config: int
    m_tiles: int
    n_tiles: int
    k_blocks: int
    splits: int
    slots: int = 1

    @property
    def tile(self) -> tuple[int, int]:
        return TILE_CONFIGS[self.config]

    @property
    def ctas(self) -> int:
        return self.n_tiles * self.splits * self.m_tiles * self.slots

    def k_range(self, split: int) -> tuple[int, int]:
        """The k blocks ``[first, end)`` of a split, by the kernel's rule."""
        return split * self.k_blocks // self.splits, (split + 1) * self.k_blocks // self.splits

    @property
    def workspace_bytes(self) -> int:
        """Counters and f32 partials the launch uses (0 without a split)."""
        if self.splits == 1:
            return 0
        bm, bn = self.tile
        tiles = self.slots * self.m_tiles * self.n_tiles
        return COUNTER_SLOTS * 4 + tiles * self.splits * bm * bn * 4


def gemm_plan(M: int, N: int, K: int, slots: int = 1) -> GemmPlan:
    """The tile and K split of an ``M x K`` by ``K x N`` product, for each
    of ``slots`` independent products (the delta kernel's adapter slots).

    Prefill (M > 64): 128 x 128 tiles. Decode: 64 x 256 where N gives at
    least 128 such tiles (the head, whose activations would otherwise be
    read once per narrow tile), else 64 x 64. Where the tiles of one slot
    are fewer than the SMs, K is split so that they fill the card (at most
    one split per k block), as far as the workspace and its counters hold
    the partials of every slot."""
    config = 0 if M > 64 else 1 if N >= 128 * 256 else 2
    bm, bn = TILE_CONFIGS[config]
    m_tiles, n_tiles, k_blocks = -(-M // bm), -(-N // bn), -(-K // K_BLOCK)
    tiles = m_tiles * n_tiles
    splits = 1 if tiles >= SMS else min(k_blocks, -(-SMS // tiles))
    plan = GemmPlan(config, m_tiles, n_tiles, k_blocks, splits, slots)
    while plan.splits > 1 and (
        slots * tiles > COUNTER_SLOTS or plan.workspace_bytes > WORKSPACE_BYTES
    ):
        plan = dataclasses.replace(plan, splits=plan.splits - 1)
    return plan


def w4a16_plan(M: int, N: int, K: int, group_size: int, width: int) -> GemmPlan | None:
    """``w4a16_matmul``'s plan for ``x [M, K]`` times a packed weight of
    stored ``width`` columns, ``N`` of them read; None where the group cuts
    a 16-deep step (GPT-OSS's 120 and 100) or the stored width is not a
    multiple of 8: the mma.sync kernel (``w4a16_matmul_mma``) takes those."""
    if group_size % 16 or width % 8:
        return None
    return gemm_plan(M, N, K)


_workspaces: dict[tuple[str, torch.device], torch.Tensor] = {}


def workspace(kernel: str, device) -> torch.Tensor:
    """``kernel``'s split-K workspace on ``device``: counters zeroed once,
    then kept zero by the kernel, and room for any plan's partials.
    Allocated at the first call and kept, so that no call allocates it
    again (a CUDA graph can capture the call). One stream at a time."""
    key = (kernel, torch.device(device))
    ws = _workspaces.get(key)
    if ws is None:
        ws = _workspaces[key] = torch.zeros(WORKSPACE_BYTES, dtype=torch.uint8, device=device)
    return ws


# ---------------------------------------------------------------- layout


def pack_w4(ql: QuantizedLinear) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Nibble planes (``q [..., In/2, N]``, ``s``/``z [..., G, N]``) -> the
    packed layout ``(q [..., N, Kp/2], s [..., G, N], z - 8 [..., G, N])``,
    on ``ql.q``'s device."""
    planes = ql.q
    In = planes.shape[-2] * 2
    nib = torch.cat([planes & 0xF, planes >> 4], dim=-2)  # [..., In, N]
    codes = (nib ^ 8).transpose(-1, -2)  # [..., N, In]
    codes = F.pad(codes, (0, padded_in(In) - In))
    q = (codes[..., 0::2] | (codes[..., 1::2] << 4)).contiguous()
    z = (ql.z.float() - 8.0).to(torch.bfloat16)  # integers: exact in bf16
    return q, ql.s.to(torch.bfloat16).contiguous(), z.contiguous()


def unpack_w4(q: torch.Tensor, in_features: int) -> torch.Tensor:
    """The signed codes (nibble - 8) of a packed ``q [..., N, Kp/2]`` as
    int8 ``[..., In, N]``."""
    p = torch.stack([q & 0xF, q >> 4], dim=-1).flatten(-2)[..., :in_features]
    codes = p.to(torch.int8)
    codes = torch.where(codes >= 8, codes - 16, codes)
    return codes.transpose(-1, -2)


def check_w4_shape(in_features: int, group_size: int) -> None:
    """What the kernels take: In even, groups that tile In, and no more
    groups than the quantizer's shared memory holds."""
    if in_features <= 0 or in_features % 2:
        raise ValueError(f"in_features {in_features} must be even and positive")
    if group_size <= 0 or in_features % group_size:
        raise ValueError(f"group_size {group_size} must divide in_features {in_features}")
    if in_features // group_size > MAX_GROUPS:
        raise ValueError(f"{in_features // group_size} groups exceed {MAX_GROUPS}")


# ---------------------------------------------------------------- plain versions


def quantize_activations_plain(x: torch.Tensor, group_size: int):
    """Per-token symmetric int8 quantization, the JAX package's formula
    (``pallas_w4.py:453-460``): ``ax = amax / 127`` (1 for a row of zeros),
    ``x8 = clip(round_half_even(x / ax), -127, 127)``, ``gsum`` the f32 sum
    of each group of x8. Returns ``x8 int8 [M, Kp]`` (zeros past In),
    ``ax f32 [M, 1]``, ``gsum f32 [M, G]``."""
    M, In = x.shape
    xf = x.float()
    amax = xf.abs().amax(dim=1, keepdim=True)
    # a tensor divisor: PyTorch's CUDA division by a Python scalar multiplies
    # by its reciprocal, which is not the IEEE quotient
    ax = torch.where(amax == 0.0, torch.ones_like(amax), amax / torch.full_like(amax, 127.0))
    x8 = torch.clamp(torch.round(xf / ax), -127, 127).to(torch.int8)
    gsum = x8.reshape(M, In // group_size, group_size).sum(2, dtype=torch.int32).float()
    return F.pad(x8, (0, padded_in(In) - In)), ax, gsum


def _group_dots(xf, q, s, group_size, out_features):
    """sum_g (x_g @ c_g) * s_g in f32, group by group; with integer x the
    f32 dots are exact (every partial sum is an integer below 2**24)."""
    G = s.shape[0]
    In = G * group_size
    codes = unpack_w4(q, In)[:, :out_features].float()
    sf = s[:, :out_features].float()
    acc = torch.zeros(xf.shape[0], out_features, dtype=torch.float32, device=xf.device)
    for g in range(G):
        sl = slice(g * group_size, (g + 1) * group_size)
        acc = acc + (xf[:, sl] @ codes[sl]) * sf[g]
    return acc, sf


def w4a8_matmul_plain(x8, ax, gsum, q, s, z, group_size: int, out_features: int):
    """f32 ``[M, out_features]``: ``ax * (sum_g (x8_g @ c_g)_i32 * s_g +
    gsum @ (-z * s))``, the math of ``w4a8_matmul_xla`` and the epilogue
    order of ``_w4a8_kernel_q4``."""
    In = s.shape[0] * group_size
    acc, sf = _group_dots(x8[:, :In].float(), q, s, group_size, out_features)
    zf = z[:, :out_features].float()
    acc = acc + gsum @ (-(zf * sf))
    return acc * ax


def w4a16_matmul_plain(x, q, s, z, group_size: int, out_features: int):
    """f32 ``[M, out_features]``: ``sum_g (x_g @ c_g) * s_g - xg_sum @ (z *
    s)``, the group-factored f32 math of ``_w4_kernel_q4``."""
    M, In = x.shape
    xf = x.float()
    acc, sf = _group_dots(xf, q, s, group_size, out_features)
    zf = z[:, :out_features].float()
    xg_sum = xf.reshape(M, In // group_size, group_size).sum(2)
    return acc - xg_sum @ (zf * sf)


# ---------------------------------------------------------------- wrappers


def _check_weight(q, s, z, in_features, group_size, out_features) -> None:
    check_w4_shape(in_features, group_size)
    G = in_features // group_size
    if q.dtype != torch.uint8 or q.dim() != 2 or q.shape[1] != padded_in(in_features) // 2:
        raise ValueError(f"q must be uint8 [N, {padded_in(in_features) // 2}], got {q.dtype} {tuple(q.shape)}")
    for name, t in (("s", s), ("z", z)):
        if t.dtype != torch.bfloat16 or t.shape != (G, q.shape[0]):
            raise ValueError(f"{name} must be bf16 [{G}, {q.shape[0]}], got {t.dtype} {tuple(t.shape)}")
    if not 0 < out_features <= q.shape[0]:
        raise ValueError(f"out_features {out_features} not in 1..{q.shape[0]}")
    for name, t in (("q", q), ("s", s), ("z", z)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_rows(name, t, dtype, cols) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != 2 or t.shape[1] != cols:
        raise ValueError(f"{name} must be [M, {cols}], got {tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def quantize_rows_int8(x: torch.Tensor, group_size: int):
    """``(x8 [M, Kp], ax [M, 1], gsum [M, G])`` of bf16 ``x [M, In]``; see
    ``quantize_activations_plain``, which the kernel matches bit for bit."""
    if x.device.type == "cpu":
        return quantize_activations_plain(x, group_size)
    if x.device.type != "cuda":
        raise ValueError(f"quantize_rows_int8: unsupported device {x.device}")
    M, In = x.shape
    check_w4_shape(In, group_size)
    _check_rows("x", x, torch.bfloat16, In)
    lib = native.load("w4a8_matmul", _SIGNATURES_A8)
    Kp = padded_in(In)
    x8 = torch.empty(M, Kp, dtype=torch.int8, device=x.device)
    ax = torch.empty(M, 1, dtype=torch.float32, device=x.device)
    gsum = torch.empty(M, In // group_size, dtype=torch.float32, device=x.device)
    rc = lib.w4_quantize_rows(
        x.data_ptr(), M, In, In, Kp, group_size, x8.data_ptr(), ax.data_ptr(),
        gsum.data_ptr(), native.stream_handle(x.device),
    )
    if rc != 0:
        raise RuntimeError(f"w4_quantize_rows launch failed: cudaError {rc}")
    quantize_rows_int8.launches += 1
    return x8, ax, gsum


quantize_rows_int8.launches = 0


def w4a8_matmul(x8, ax, gsum, q, s, z, group_size: int, out_features: int) -> torch.Tensor:
    """``[M, out_features]`` W4A8 product (bf16 from the kernel, f32 from
    the plain version) of ``quantize_rows_int8``'s output and a packed
    weight (see ``csrc/w4a8_matmul.cu``)."""
    native.check_same_device(x8, ax, gsum, q, s, z)
    if x8.device.type == "cpu":
        return w4a8_matmul_plain(x8, ax, gsum, q, s, z, group_size, out_features)
    if x8.device.type != "cuda":
        raise ValueError(f"w4a8_matmul: unsupported device {x8.device}")
    In = s.shape[0] * group_size
    _check_weight(q, s, z, In, group_size, out_features)
    M = x8.shape[0]
    _check_rows("x8", x8, torch.int8, padded_in(In))
    _check_rows("ax", ax, torch.float32, 1)
    _check_rows("gsum", gsum, torch.float32, s.shape[0])
    if ax.shape[0] != M or gsum.shape[0] != M:
        raise ValueError("x8, ax and gsum must have the same rows")
    lib = native.load("w4a8_matmul", _SIGNATURES_A8)
    y = torch.empty(M, out_features, dtype=torch.bfloat16, device=x8.device)
    rc = lib.w4a8_matmul(
        x8.data_ptr(), ax.data_ptr(), gsum.data_ptr(), q.data_ptr(), s.data_ptr(),
        z.data_ptr(), y.data_ptr(), M, out_features, In, padded_in(In), group_size,
        s.shape[1], native.stream_handle(x8.device),
    )
    if rc != 0:
        raise RuntimeError(f"w4a8_matmul launch failed: cudaError {rc}")
    w4a8_matmul.launches += 1
    return y


w4a8_matmul.launches = 0


def _w4a16_launch(lib, x, q, s, z, group_size: int, out_features: int) -> torch.Tensor:
    M, In = x.shape
    _check_weight(q, s, z, In, group_size, out_features)
    _check_rows("x", x, torch.bfloat16, In)
    y = torch.empty(M, out_features, dtype=torch.bfloat16, device=x.device)
    args = (
        x.data_ptr(), q.data_ptr(), s.data_ptr(), z.data_ptr(), y.data_ptr(), M, out_features,
        In, In, padded_in(In), group_size, s.shape[1], native.stream_handle(x.device),
    )
    plan = w4a16_plan(M, out_features, In, group_size, s.shape[1])
    if plan is None:
        rc = lib.w4a16_matmul_mma(*args)
    else:
        ws = workspace("w4a16_matmul", x.device)
        rc = lib.w4a16_matmul(*args, ws.data_ptr(), plan.config, plan.splits)
    if rc != 0:
        raise RuntimeError(f"w4a16_matmul launch failed: cudaError {rc}")
    return y


def w4a16_matmul(x, q, s, z, group_size: int, out_features: int) -> torch.Tensor:
    """``[M, out_features]`` product of ``x [M, In]`` and a packed weight
    (bf16 from the kernel, f32 from the plain version; see
    ``csrc/w4a16_matmul.cu``, launched on ``w4a16_plan``'s plan)."""
    native.check_same_device(x, q, s, z)
    if x.device.type == "cpu":
        return w4a16_matmul_plain(x, q, s, z, group_size, out_features)
    if x.device.type != "cuda":
        raise ValueError(f"w4a16_matmul: unsupported device {x.device}")
    y = _w4a16_launch(native.load("w4a16_matmul", _SIGNATURES_A16), x, q, s, z, group_size,
                      out_features)
    w4a16_matmul.launches += 1
    return y


w4a16_matmul.launches = 0


def w4a16_matmul_cut(x, q, s, z, group_size: int, out_features: int) -> torch.Tensor:
    """The kernel built with ``GEMM_CUT``, for timing only: it loads and
    converts every block and takes no product, so its output is not the
    product. Card only; groups that ``w4a16_plan`` sends to the mma.sync
    kernel raise."""
    native.check_same_device(x, q, s, z)
    if x.device.type != "cuda":
        raise ValueError("w4a16_matmul_cut runs on the card only")
    if w4a16_plan(x.shape[0], out_features, x.shape[1], group_size, s.shape[1]) is None:
        raise ValueError(f"group {group_size} runs the mma.sync kernel, which has no cut")
    y = _w4a16_launch(native.load("w4a16_matmul", _SIGNATURES_A16, GEMM_CUT), x, q, s, z,
                      group_size, out_features)
    return y

