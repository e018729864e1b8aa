"""4-bit weight GEMMs: the port's packed layout, the CUDA kernels' wrappers
and their plain versions.

Counterpart of ``scratchpad_tpu/ops/quant/pallas_w4.py``, whose four Pallas
kernels (``_w4a8_kernel_q4``, ``_w4a8_kernel``, ``_w4_kernel_q4``,
``_w4_kernel``) become the hand-written CUDA kernels of
``csrc/w4a8_matmul.cu`` and ``csrc/w4a16_matmul.cu``, which between them
take every group size; the per-token int8 quantization of the activations,
which the JAX package leaves to XLA, is another (``w4_quantize_rows`` in
``w4a8_matmul.cu``).

``gemm_plan`` is the launch plan of the Hopper GEMM mainloop
(``csrc/sm90_gemm.cuh``) that ``w4a16_matmul``, W4A8's prefill and the
delta kernel (``ops/ldmm.py``) run on: the output tile, the K split and the
split-K workspace, which each wrapper allocates once per device and keeps.
``w4a8_plan`` adds W4A8's decode kernel (swap-AB). Both take every group
of at least one tensor-core step (16 bf16 or 32 int8 deep), those that cut
a step too (GPT-OSS's 120 and 100): the kernels issue such a step twice,
each issue holding one group's codes, and fold between them. The smaller
groups run the ``mma.sync`` kernels (``w4a16_matmul_mma``,
``w4a8_matmul_mma``).

The packed layout, one for every group size. A weight W[In, Out] of
``w4a16.QuantizedLinear`` (nibble planes) is stored as

    q : uint8 [N, Kp/2]  Kp = In rounded up to a multiple of 32. Byte (n, j)
                         holds the code of row 2j in its low nibble and of
                         row 2j + 1 in its high nibble; rows past In hold 0.
                         A code is nibble - 8 in 4-bit two's complement
                         (nibble ^ 8), so it sign-extends to an int8 that
                         the s8 tensor cores take as it is.
    s : bf16 [G, N]      scales, G = In / group_size
    z : bf16 [G, N]      zero points as ``QuantizedLinear.z`` holds them,
                         so w = (nibble - z) * s = (code - (z - 8)) * s

with N the stored (possibly padded) width. Each output column's codes are
contiguous along In: that is the ``.col`` B operand of ``mma.sync``. The
zero point is never stored as a nibble (GPTQ v1 zeros reach 16), nor
shifted: every reader takes z - 8 in f32 or folds the 8 into its own
code-zero arithmetic, which is exact, as the JAX package's ``to_4bit``
(z - 8 in f32) is. A bf16 z - 8 would round the zero a second time
wherever |z| passes 256 (z -31,000: -30,976 in bf16, -30,968 after it).

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
    "w4_quantize_rows": ([_P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P], ctypes.c_int),
    "w4a8_matmul": ([_P] * 7 + [_I] * 6 + [_P, _P, _I, _I, _I, _I], ctypes.c_int),
    "w4a8_matmul_mma": ([_P] * 7 + [_I] * 6 + [_P, _I], ctypes.c_int),
}
_SIGNATURES_A16 = {
    "w4a16_matmul": ([_P] * 5 + [_I] * 7 + [_P, _P, _I, _I], ctypes.c_int),
    "w4a16_matmul_mma": ([_P] * 5 + [_I] * 7 + [_P], ctypes.c_int),
}
# the timing cut of csrc/sm90_gemm.cuh (and of W4A8's decode kernel): every
# block loaded and converted, no products, nothing written (tools/gemm_ab.py)
GEMM_CUT = {"SPTPU_GEMM_CUT": 1}
K_ALIGN = 32
# the quantizer keeps one int per group in shared memory, and a row in the
# registers of at most 1,024 threads
MAX_GROUPS = 227 * 1024 // 4
MAX_PADDED_IN = 131072


def padded_in(in_features: int) -> int:
    return -(-in_features // K_ALIGN) * K_ALIGN


# ---------------------------------------------------------------- launch plan

SMS = 132  # streaming multiprocessors of one H100 SXM
K_BLOCK = 64  # the mainloop's k block over bf16 x (kKB): one 128-byte row
K_BLOCK_S8 = 128  # the same 128 bytes of int8 x (W4A8's prefill)
DECODE_K_BLOCK = 64  # W4A8's decode kernel (kDecodeKB)
DECODE_TOKENS = (8, 16, 32, 64)  # its wgmma N: M rounded up
# at most this many (64-column tile, 64-deep block) pairs: the 64 tokens of
# a decode batch go in two tiles of 32 (tools/gemm_ab.py, PERF.md)
SPLIT_TOKENS = 1024
# the tile configurations of csrc/sm90_gemm.cuh's mainloop, by the id the
# kernels take: (rows, columns) of a CTA's output tile
TILE_CONFIGS = {0: (128, 128), 1: (64, 256), 2: (64, 64)}
# W4A8's decode kernel (csrc/w4a8_matmul.cu): one warpgroup of 64 columns,
# the plan's token tile (one of DECODE_TOKENS) its rows
DECODE_CONFIG = 3
DECODE_COLUMNS = 64
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
    k_block: int = K_BLOCK  # the depth of a k block, in elements
    rows: int = 0  # DECODE_CONFIG's token tile

    @property
    def tile(self) -> tuple[int, int]:
        if self.config == DECODE_CONFIG:
            return self.rows, DECODE_COLUMNS
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


def gemm_plan(M: int, N: int, K: int, slots: int = 1, k_block: int = K_BLOCK) -> GemmPlan:
    """The tile and K split of the mainloop's ``M x K`` by ``K x N`` product
    in k blocks of ``k_block`` (64 over bf16 x, 128 over int8 x), for each
    of ``slots`` independent products (the delta kernel's adapter slots).

    Prefill (M > 64) 128 x 128 tiles; decode 64 x 256 where N gives at least
    128 such tiles (the head, whose activations would otherwise be read once
    per narrow tile), else 64 x 64. Where the tiles of one slot are fewer
    than the SMs, K is split so that they fill the card (at most one split
    per k block), as far as the workspace and its counters hold the partials
    of every slot."""
    config = 0 if M > 64 else 1 if N >= 128 * 256 else 2
    bm, bn = TILE_CONFIGS[config]
    m_tiles, n_tiles, k_blocks = -(-M // bm), -(-N // bn), -(-K // k_block)
    tiles = m_tiles * n_tiles
    splits = 1 if tiles >= SMS else min(k_blocks, -(-SMS // tiles))
    return _fit_workspace(GemmPlan(config, m_tiles, n_tiles, k_blocks, splits, slots, k_block))


def _fit_workspace(plan: GemmPlan) -> GemmPlan:
    """``plan`` with as many of its splits as the workspace and its counters
    hold."""
    while plan.splits > 1 and (
        plan.slots * plan.m_tiles * plan.n_tiles > COUNTER_SLOTS or plan.workspace_bytes > WORKSPACE_BYTES
    ):
        plan = dataclasses.replace(plan, splits=plan.splits - 1)
    return plan


def w4a16_plan(M: int, N: int, K: int, group_size: int, width: int) -> GemmPlan | None:
    """``w4a16_matmul``'s plan for ``x [M, K]`` times a packed weight of
    stored ``width`` columns, ``N`` of them read. Every group of 16 or more
    (a group that cuts a 16-deep step, as GPT-OSS's 120 and 100 do, splits
    that step in two, see ``step_cut``). None, the remainder that the
    mma.sync kernel (``w4a16_matmul_mma``) takes: a group below 16 (a step
    would hold more than one group edge), a K that is no multiple of 8 (x's
    rows are no whole 16 bytes for the TMA), or a stored width that is no
    multiple of 8."""
    if group_size < 16 or K % 8 or width % 8:
        return None
    return gemm_plan(M, N, K)


def step_cut(j: int, group_size: int, step: int) -> int:
    """Where a group edge falls strictly inside ``step``-deep step ``j``
    (16 over bf16 x, 32 over int8 x), as an offset in 1..step - 1 from the
    step's first k, or 0 where none does. With groups of at least ``step``
    a step holds at most one edge: the kernels issue such a step twice, the
    first issue holding the codes before the edge (the others zero), the
    second those from it, and fold the first group between the two."""
    edge = (step * j // group_size + 1) * group_size
    return edge - step * j if edge < step * (j + 1) else 0


def w4a8_plan(M: int, N: int, K: int, group_size: int, width: int) -> GemmPlan | None:
    """``w4a8_matmul``'s plan for int8 rows ``x8 [M, K]`` times a packed
    weight of stored ``width`` columns, ``N`` of them read. Every group of
    32 or more (one that cuts a 32-deep step, as GPT-OSS's 120 and 100 do,
    splits that step in two, see ``step_cut``). None, the remainder that the
    mma.sync kernel (``w4a8_matmul_mma``) takes: a group below 32, or a
    stored width that is no multiple of 8.

    Prefill (M > 64): the mainloop's 128 x 128 tile (config 0: two
    warpgroups along M share one s8 B tile, each converting half of it),
    128-deep blocks. Decode: the swap-AB kernel (config 3), 64 columns a
    CTA, 64-deep blocks, the tokens rounded up to 8, 16, 32 or 64 a tile,
    or two tiles of 32 where the tiles of 64 columns times the k blocks are
    at most SPLIT_TOKENS (the small projections, whose time goes to each
    split's sum). K is split for at least one CTA an SM, and up to two
    (rounded down) where each split keeps 8 k blocks (512 k), as far as the
    workspace holds. A group that cuts a 32-deep step waits for its products
    after every step, so its splits go up to three CTAs an SM, each keeping
    4 k blocks (GPT-OSS's 2880 -> 5760: 4 splits, 360 CTAs, against 2 by
    the other rule; ``tools/gemm_ab.py``'s sweep)."""
    if group_size < 32 or width % 8:
        return None
    if M > 64:
        return gemm_plan(M, N, K, k_block=K_BLOCK_S8)
    rows = next(t for t in DECODE_TOKENS if t >= M)
    if rows == 64 and -(-N // DECODE_COLUMNS) * -(-K // DECODE_K_BLOCK) <= SPLIT_TOKENS:
        rows = 32
    if group_size % 32:
        return w4a8_decode_plan(M, N, K, rows, per_sm=3, min_blocks=4)
    return w4a8_decode_plan(M, N, K, rows)


def w4a8_decode_plan(M: int, N: int, K: int, rows: int, splits: int | None = None, per_sm: int = 2,
                     min_blocks: int = 8) -> GemmPlan:
    """The decode kernel's plan at a token tile of ``rows`` (one of
    ``DECODE_TOKENS``), K split by ``w4a8_plan``'s rule (at least one CTA an
    SM, up to ``per_sm`` where each split keeps ``min_blocks`` k blocks), or
    ``splits`` ways (``tools/gemm_ab.py``'s sweep of the rule's
    neighbours): at most one split a k block, and as many as the workspace
    holds."""
    if M > 64 or rows not in DECODE_TOKENS:
        raise ValueError(f"no decode plan for M {M} in token tiles of {rows}")
    m_tiles, n_tiles, k_blocks = -(-M // rows), -(-N // DECODE_COLUMNS), -(-K // DECODE_K_BLOCK)
    tiles = m_tiles * n_tiles
    if splits is None:
        splits = 1 if tiles >= SMS else max(-(-SMS // tiles), min(per_sm * SMS // tiles, k_blocks // min_blocks))
    plan = GemmPlan(DECODE_CONFIG, m_tiles, n_tiles, k_blocks, max(1, min(splits, k_blocks)),
                    k_block=DECODE_K_BLOCK, rows=rows)
    return _fit_workspace(plan)


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
    packed layout ``(q [..., N, Kp/2], s [..., G, N], z [..., G, N])``, on
    ``ql.q``'s device; s and z are the planes' own bf16 values."""
    planes = ql.q
    In = planes.shape[-2] * 2
    nib = torch.cat([planes & 0xF, planes >> 4], dim=-2)  # [..., In, N]
    codes = (nib ^ 8).transpose(-1, -2)  # [..., N, In]
    codes = F.pad(codes, (0, padded_in(In) - In))
    q = (codes[..., 0::2] | (codes[..., 1::2] << 4)).contiguous()
    return q, ql.s.to(torch.bfloat16).contiguous(), ql.z.to(torch.bfloat16).contiguous()


def unpack_w4(q: torch.Tensor, in_features: int) -> torch.Tensor:
    """The signed codes (nibble - 8) of a packed ``q [..., N, Kp/2]`` as
    int8 ``[..., In, N]``."""
    p = torch.stack([q & 0xF, q >> 4], dim=-1).flatten(-2)[..., :in_features]
    codes = p.to(torch.int8)
    codes = torch.where(codes >= 8, codes - 16, codes)
    return codes.transpose(-1, -2)


def check_w4_shape(in_features: int, group_size: int) -> None:
    """What the kernels take: In even, groups that tile In, no more groups
    than the quantizer's shared memory holds and no longer row than its
    registers hold."""
    if in_features <= 0 or in_features % 2:
        raise ValueError(f"in_features {in_features} must be even and positive")
    if group_size <= 0 or in_features % group_size:
        raise ValueError(f"group_size {group_size} must divide in_features {in_features}")
    if in_features // group_size > MAX_GROUPS:
        raise ValueError(f"{in_features // group_size} groups exceed {MAX_GROUPS}")
    if padded_in(in_features) > MAX_PADDED_IN:
        raise ValueError(f"in_features {in_features} exceeds {MAX_PADDED_IN}")


# ---------------------------------------------------------------- plain versions


def quantize_activations_plain(x: torch.Tensor, group_size: int, amax=None):
    """Per-token symmetric int8 quantization, the JAX package's formula
    (``pallas_w4.py:453-460``): ``ax = amax / 127`` (1 for a row of zeros),
    ``x8 = clip(round_half_even(x / ax), -127, 127)``, ``gsum`` the f32 sum
    of each group of x8. Returns ``x8 int8 [M, Kp]`` (zeros past In),
    ``ax f32 [M, 1]``, ``gsum f32 [M, G]``. ``amax``: each row's f32 [M, 1]
    max |x| taken elsewhere (a row-parallel projection's, over the whole
    input row: ``x`` is then a rank's slice of it), else ``x``'s own."""
    M, In = x.shape
    xf = x.float()
    if amax is None:
        amax = xf.abs().amax(dim=1, keepdim=True)
    # a tensor divisor: PyTorch's CUDA division by a Python scalar multiplies
    # by its reciprocal, which is not the IEEE quotient
    ax = torch.where(amax == 0.0, torch.ones_like(amax), amax / torch.full_like(amax, 127.0))
    x8 = torch.clamp(torch.round(xf / ax), -127, 127).to(torch.int8)
    gsum = x8.reshape(M, In // group_size, group_size).sum(2, dtype=torch.int32).float()
    return F.pad(x8, (0, padded_in(In) - In)), ax, gsum


def row_amax(x: torch.Tensor) -> torch.Tensor:
    """f32 [M, 1]: each row's max |x| (exact in f32, whatever the order)."""
    return x.float().abs().amax(dim=1, keepdim=True)


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


def _zero_minus_8(z, out_features: int) -> torch.Tensor:
    """z - 8 in f32, exact: the zero point of the signed codes (nibble -
    8), as the JAX package's ``to_4bit`` holds it."""
    return z[:, :out_features].float() - 8.0


def w4a8_matmul_plain(x8, ax, gsum, q, s, z, group_size: int, out_features: int, f32: bool = True):
    """f32 ``[M, out_features]``: ``ax * (sum_g (x8_g @ c_g)_i32 * s_g +
    gsum @ (-(z - 8) * s))``, the math of ``w4a8_matmul_xla`` and the
    epilogue order of ``_w4a8_kernel_q4``. ``f32``: the wrapper's flag,
    taken so that the plain version stands in for it; f32 either way."""
    In = s.shape[0] * group_size
    acc, sf = _group_dots(x8[:, :In].float(), q, s, group_size, out_features)
    zf = _zero_minus_8(z, out_features)
    acc = acc + gsum @ (-(zf * sf))
    return acc * ax


def w4a16_matmul_plain(x, q, s, z, group_size: int, out_features: int):
    """f32 ``[M, out_features]``: ``sum_g (x_g @ c_g) * s_g - xg_sum @ ((z
    - 8) * s)``, the group-factored f32 math of ``_w4_kernel_q4``."""
    M, In = x.shape
    xf = x.float()
    acc, sf = _group_dots(xf, q, s, group_size, out_features)
    zf = _zero_minus_8(z, out_features)
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


def quantize_rows_int8(x: torch.Tensor, group_size: int, amax=None):
    """``(x8 [M, Kp], ax [M, 1], gsum [M, G])`` of bf16 ``x [M, In]``; see
    ``quantize_activations_plain``, which the kernel matches bit for bit.
    ``amax``: f32 [M, 1] row maxima given to the kernel, which then takes
    no maximum of its own."""
    if amax is not None:
        native.check_same_device(x, amax)
    if x.device.type == "cpu":
        return quantize_activations_plain(x, group_size, amax)
    if x.device.type != "cuda":
        raise ValueError(f"quantize_rows_int8: unsupported device {x.device}")
    M, In = x.shape
    check_w4_shape(In, group_size)
    _check_rows("x", x, torch.bfloat16, In)
    if amax is not None and (amax.dtype != torch.float32 or amax.shape != (M, 1) or not amax.is_contiguous()):
        raise ValueError(f"amax must be contiguous f32 [{M}, 1], got {amax.dtype} {tuple(amax.shape)}")
    lib = native.load("w4a8_matmul", _SIGNATURES_A8)
    Kp = padded_in(In)
    x8 = torch.empty(M, Kp, dtype=torch.int8, device=x.device)
    ax = torch.empty(M, 1, dtype=torch.float32, device=x.device)
    gsum = torch.empty(M, In // group_size, dtype=torch.float32, device=x.device)
    rc = lib.w4_quantize_rows(
        x.data_ptr(), M, In, In, Kp, group_size, x8.data_ptr(), ax.data_ptr(),
        gsum.data_ptr(), None if amax is None else amax.data_ptr(), native.stream_handle(x.device),
    )
    if rc != 0:
        raise RuntimeError(f"w4_quantize_rows launch failed: cudaError {rc}")
    quantize_rows_int8.launches += 1
    return x8, ax, gsum


quantize_rows_int8.launches = 0


def _check_a8(x8, ax, gsum, q, s, z, group_size: int, out_features: int) -> int:
    In = s.shape[0] * group_size
    _check_weight(q, s, z, In, group_size, out_features)
    M = x8.shape[0]
    _check_rows("x8", x8, torch.int8, padded_in(In))
    _check_rows("ax", ax, torch.float32, 1)
    _check_rows("gsum", gsum, torch.float32, s.shape[0])
    if ax.shape[0] != M or gsum.shape[0] != M:
        raise ValueError("x8, ax and gsum must have the same rows")
    return In


def count_launch(wrapper, group_size: int) -> None:
    """One launch of ``wrapper``'s kernel: its ``launches`` and its
    ``group_launches`` at ``group_size`` (rows 4/5 and 6/7 of the kernel
    table share these wrappers and differ by group)."""
    wrapper.launches += 1
    wrapper.group_launches[group_size] = wrapper.group_launches.get(group_size, 0) + 1


def _w4a8_launch(lib, x8, ax, gsum, q, s, z, group_size: int, out_features: int, plan,
                 f32: bool = False) -> torch.Tensor:
    In = s.shape[0] * group_size
    M = x8.shape[0]
    ws = workspace("w4a8_matmul", x8.device)
    y = torch.empty(M, out_features, dtype=torch.float32 if f32 else torch.bfloat16, device=x8.device)
    rc = lib.w4a8_matmul(
        x8.data_ptr(), ax.data_ptr(), gsum.data_ptr(), q.data_ptr(), s.data_ptr(), z.data_ptr(), y.data_ptr(), M,
        out_features, In, padded_in(In), group_size, s.shape[1], native.stream_handle(x8.device),
        ws.data_ptr(), plan.config, plan.splits, plan.tile[0], int(f32),
    )
    if rc != 0:
        raise RuntimeError(f"w4a8_matmul launch failed: cudaError {rc}")
    return y


def w4a8_matmul(x8, ax, gsum, q, s, z, group_size: int, out_features: int, f32: bool = False) -> torch.Tensor:
    """``[M, out_features]`` W4A8 product (bf16 from the kernel, f32 with
    ``f32``: a tensor-parallel rank's row-parallel partial, rounded once
    after the group's f32 sum; f32 from the plain version) of
    ``quantize_rows_int8``'s output and a packed weight (see
    ``csrc/w4a8_matmul.cu``), launched on ``w4a8_plan``'s plan; the groups
    that plan gives no plan (below 32) run ``w4a8_matmul_mma``. The wgmma
    kernels fold the zero point into the codes and read ``gsum`` only for a
    group whose zero lies outside [0, 16] (or is no integer)."""
    native.check_same_device(x8, ax, gsum, q, s, z)
    if x8.device.type == "cpu":
        return w4a8_matmul_plain(x8, ax, gsum, q, s, z, group_size, out_features)
    In = s.shape[0] * group_size
    plan = w4a8_plan(x8.shape[0], out_features, In, group_size, s.shape[1])
    if plan is None:
        return w4a8_matmul_mma(x8, ax, gsum, q, s, z, group_size, out_features, f32)
    return w4a8_matmul_with_plan(x8, ax, gsum, q, s, z, group_size, out_features, plan, f32)


w4a8_matmul.launches = 0
w4a8_matmul.group_launches = {}


def _check_a8_plan(plan: GemmPlan, M: int, N: int, K: int, group_size: int) -> None:
    """What the kernel's indexing takes of a plan: the tile and the k block
    of its M, the tiles covering the output, 1 to k_blocks splits, and
    their partials within the workspace."""
    decode = M <= 64
    ok = group_size >= 32 and plan.slots == 1 and plan.config == (DECODE_CONFIG if decode else 0)
    ok = ok and plan.k_block == (DECODE_K_BLOCK if decode else K_BLOCK_S8)
    ok = ok and (not decode or plan.rows in DECODE_TOKENS)
    if ok:
        bm, bn = plan.tile
        ok = (plan.m_tiles, plan.n_tiles, plan.k_blocks) == (-(-M // bm), -(-N // bn), -(-K // plan.k_block))
        ok = ok and 1 <= plan.splits <= plan.k_blocks and _fit_workspace(plan) == plan
    if not ok:
        raise ValueError(f"{plan} does not fit a W4A8 product of M {M}, N {N}, K {K}, group {group_size}")


def w4a8_matmul_with_plan(x8, ax, gsum, q, s, z, group_size: int, out_features: int,
                          plan: GemmPlan, f32: bool = False) -> torch.Tensor:
    """``w4a8_matmul`` on a given plan of ``w4a8_plan``'s kind (another
    token tile or K split: ``tools/gemm_ab.py``'s sweep). Raises where the
    plan does not fit the product; the plain version on the CPU."""
    native.check_same_device(x8, ax, gsum, q, s, z)
    In = s.shape[0] * group_size
    _check_a8_plan(plan, x8.shape[0], out_features, In, group_size)
    if x8.device.type == "cpu":
        return w4a8_matmul_plain(x8, ax, gsum, q, s, z, group_size, out_features)
    if x8.device.type != "cuda":
        raise ValueError(f"w4a8_matmul: unsupported device {x8.device}")
    _check_a8(x8, ax, gsum, q, s, z, group_size, out_features)
    y = _w4a8_launch(native.load("w4a8_matmul", _SIGNATURES_A8), x8, ax, gsum, q, s, z, group_size,
                     out_features, plan, f32)
    count_launch(w4a8_matmul, group_size)
    return y


def w4a8_matmul_cut(x8, ax, gsum, q, s, z, group_size: int, out_features: int) -> torch.Tensor:
    """The kernel built with ``GEMM_CUT``, for timing only: it loads and
    converts every block and takes no product, so its output is not the
    product. Card only; groups that ``w4a8_plan`` sends to the mma.sync
    kernel raise."""
    native.check_same_device(x8, ax, gsum, q, s, z)
    if x8.device.type != "cuda":
        raise ValueError("w4a8_matmul_cut runs on the card only")
    In = _check_a8(x8, ax, gsum, q, s, z, group_size, out_features)
    plan = w4a8_plan(x8.shape[0], out_features, In, group_size, s.shape[1])
    if plan is None:
        raise ValueError(f"group {group_size} runs the mma.sync kernel, which has no cut")
    return _w4a8_launch(native.load("w4a8_matmul", _SIGNATURES_A8, GEMM_CUT), x8, ax, gsum, q, s, z,
                        group_size, out_features, plan)


def w4a8_matmul_mma(x8, ax, gsum, q, s, z, group_size: int, out_features: int, f32: bool = False) -> torch.Tensor:
    """The mma.sync kernel (``w4a8_matmul_mma`` in ``csrc/w4a8_matmul.cu``,
    any group dividing In, reading ``gsum``): the route of the groups below
    32, which ``w4a8_matmul`` sends here; its plain version on the CPU."""
    native.check_same_device(x8, ax, gsum, q, s, z)
    if x8.device.type == "cpu":
        return w4a8_matmul_plain(x8, ax, gsum, q, s, z, group_size, out_features)
    if x8.device.type != "cuda":
        raise ValueError(f"w4a8_matmul_mma: unsupported device {x8.device}")
    In = _check_a8(x8, ax, gsum, q, s, z, group_size, out_features)
    lib = native.load("w4a8_matmul", _SIGNATURES_A8)
    y = torch.empty(x8.shape[0], out_features, dtype=torch.float32 if f32 else torch.bfloat16, device=x8.device)
    rc = lib.w4a8_matmul_mma(
        x8.data_ptr(), ax.data_ptr(), gsum.data_ptr(), q.data_ptr(), s.data_ptr(), z.data_ptr(),
        y.data_ptr(), x8.shape[0], out_features, In, padded_in(In), group_size, s.shape[1],
        native.stream_handle(x8.device), int(f32),
    )
    if rc != 0:
        raise RuntimeError(f"w4a8_matmul_mma launch failed: cudaError {rc}")
    w4a8_matmul_mma.launches += 1
    return y


w4a8_matmul_mma.launches = 0


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
    count_launch(w4a16_matmul, group_size)
    return y


w4a16_matmul.launches = 0
w4a16_matmul.group_launches = {}


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

