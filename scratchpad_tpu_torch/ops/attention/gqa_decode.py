"""Paged GQA decode attention: the CUDA kernel's wrappers and their plain version.

Counterpart of ``scratchpad_tpu/ops/attention/gqa_decode.py``, whose two
Pallas kernels (``_gqa_decode_kernel`` and ``_gqa_decode_grouped_kernel``)
become one hand-written CUDA kernel, ``csrc/paged_decode_attention.cu``,
built for bf16 pages and for int8 and fp8 (e4m3) pages with per-(token,
head) bf16 scales, the Pallas kernels' ``quantized`` branch.

``paged_decode_attention`` (bf16 pages) and ``paged_decode_attention_quant``
(8-bit pages) take the plain PyTorch version for CPU tensors and launch the
kernel for CUDA tensors, raising on anything the kernel does not take; they
never fall back. ``sm_scale`` is applied once, inside (the JAX callers
pre-scale q instead).

Both take the Pallas kernels' ``logit_cap`` and ``sliding_window``
(``gqa_decode.py:171-172, 395-396``) as runtime arguments of each call: the
score is ``cap * tanh(s / cap)`` with ``s = sm_scale * q . k`` (for 8-bit
pages, ``s`` already holds the K scale), and token ``j`` of a row of length
``L`` is live iff ``L - W <= j < L``. The kernel reads only the window. A
window that changes from call to call is the JAX kernel's traced window
(``dynamic_window``, ``gqa_decode.py:102, 112-117``), which Gemma's layers
give one by one; ``mask_args`` reads the JAX package's global-layer
sentinel (``1 << 30``) as no window. bf16 and 8-bit pages take head_dim
32, 64, 128 and 256 (``HEAD_DIMS``).

``chunk_size`` (None or C >= 1; the Pallas kernel's ``chunk_size``,
``mask_start``, ``gqa_decode.py:166-168``, Llama-4's rope layers) keeps the
chunk of C tokens that holds the query: token ``j`` of a row of length ``L``
is live iff ``(L - 1) // C * C <= j < L``, and the kernel reads only those.
A call takes a window or a chunk, not both (the JAX ``mask_start`` would let
the chunk win; no model passes both).

``sinks`` (f32 ``[Hq]`` or None; the Pallas kernels' ``with_sinks``,
``gqa_decode.py:128-133, 421-425``, GPT-OSS) gives each query head a logit
that joins its softmax and carries no value, as
``xla_backend.decode_attention_xla:418-426`` computes it: the sink is a raw
logit (no ``sm_scale``, no cap). A row with ``seq_len == 0`` stays zeros.

``decode_plan`` splits each row's pages across CTAs where the batch alone
would leave the card short of them (B 1 gives Hkv CTAs); it reads only the
page table's width, never ``seq_lens``, so a call never waits for the card.
The CTAs of a split row merge in one launch through a workspace allocated
once per device (``workspace``).

``paged_decode_attention_stage`` launches the kernel cut after a stage of its
token loop (variant libraries of the same source), for the kernel-profiling
tool ``tools/decode_ablate.py``; ``paged_decode_attention_stage_plain``
defines what each cut writes.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch

from scratchpad_tpu_torch.executor.forward_meta import ForwardMeta
from scratchpad_tpu_torch.memory.kv_cache import SCALE_DTYPE, KVCache
from scratchpad_tpu_torch.utils import native

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "paged_decode_attention": (
        [_P] * 6 + [_I] * 6 + [ctypes.c_float, ctypes.c_float, _I, _I, _P, _I, _I, _P, _P],
        ctypes.c_int,
    ),
    "paged_decode_attention_quant": (
        [_P] * 8 + [_I] * 7 + [ctypes.c_float, ctypes.c_float, _I, _I, _P, _I, _I, _P, _P],
        ctypes.c_int,
    ),
}
HEAD_DIMS = (32, 64, 128, 256)
# a window this wide or wider is the JAX package's "global layer" sentinel
# (models/gemma.py _BIG_WINDOW = 1 << 30; ragged_backend.py's window cond
# tests < 1 << 29): no window
GLOBAL_WINDOW = 1 << 29
MAX_GROUP = 8
# code dtype -> the kernel's code type argument
CODE_TYPES = {torch.int8: 0, torch.float8_e4m3fn: 1}

# ---------------------------------------------------------------- the split

SMS = 132  # streaming multiprocessors of one H100 SXM
SPLIT_TARGET = 2 * SMS  # CTAs a split launch aims at: two an SM
MIN_SPLIT_PAGES = 4  # a split's least pages: 64 tokens at page 16, a slice for each warp
MAX_SPLITS = 128  # kMaxSplits
COUNTER_SLOTS = 8192  # kDecodeCounterSlots: i32 split counters at the workspace's head
PARTIAL_BYTES = 8 << 20  # the f32 partials a workspace holds
WORKSPACE_BYTES = COUNTER_SLOTS * 4 + PARTIAL_BYTES


@dataclasses.dataclass(frozen=True)
class DecodePlan:
    """One launch of the decode kernel: grid ``(splits, Hkv, B)``; split
    ``s`` of a row takes its pages ``[s * split_pages, (s + 1) *
    split_pages)``, the live ones of them."""

    batch: int
    num_kv_heads: int
    pages: int
    head_dim: int
    group: int
    splits: int
    split_pages: int

    @property
    def ctas(self) -> int:
        return self.splits * self.num_kv_heads * self.batch

    def page_range(self, split: int) -> tuple[int, int]:
        """The pages ``[first, end)`` of a split, by the kernel's rule."""
        return split * self.split_pages, min((split + 1) * self.split_pages, self.pages)

    @property
    def partial_floats(self) -> int:
        """One split's partial: O ``[G, D]``, m ``[G]``, l ``[G]`` (f32)."""
        return self.group * (self.head_dim + 2)

    @property
    def workspace_bytes(self) -> int:
        """Counters and partials the launch uses (0 without a split): the
        partial of split ``s`` of (row ``b``, head ``h``) at float ``((b *
        Hkv + h) * splits + s) * partial_floats`` past the counters, the
        counter of (b, h) at int ``b * Hkv + h``."""
        if self.splits == 1:
            return 0
        return COUNTER_SLOTS * 4 + self.ctas * self.partial_floats * 4


def decode_plan(B: int, Hkv: int, pages: int, D: int, G: int) -> DecodePlan:
    """The decode kernel's split for ``B`` rows of a page table ``pages``
    wide, Hkv kv heads of ``D`` lanes and ``G`` query heads each. Where the
    ``B * Hkv`` (row, head) CTAs are fewer than ``SPLIT_TARGET``, each row's
    pages are cut into ranges of at least ``MIN_SPLIT_PAGES`` so that the
    launch reaches it (B 1, Hkv 8 at 4096 tokens: 32 splits of 8 pages, 256
    CTAs), as far as the counters and the workspace hold them."""
    pairs = B * Hkv
    splits = 1
    if 0 < pairs < SPLIT_TARGET and pairs <= COUNTER_SLOTS:
        splits = max(1, min(-(-SPLIT_TARGET // pairs), pages // MIN_SPLIT_PAGES, MAX_SPLITS))
    while True:
        split_pages = max(1, -(-pages // splits))
        plan = DecodePlan(B, Hkv, pages, D, G, max(1, -(-pages // split_pages)), split_pages)
        if plan.workspace_bytes <= WORKSPACE_BYTES or splits == 1:
            return plan
        splits -= 1


_workspaces: dict[torch.device, torch.Tensor] = {}


def workspace(device) -> torch.Tensor:
    """The split workspace on ``device``: counters zeroed once, then kept
    zero by the kernel, and room for any plan's partials. Allocated at the
    first call and kept, so that no call allocates it again. One stream at
    a time."""
    device = torch.device(device)
    ws = _workspaces.get(device)
    if ws is None:
        ws = _workspaces[device] = torch.zeros(WORKSPACE_BYTES, dtype=torch.uint8, device=device)
    return ws


def _plan_args(q, k_cache, page_table) -> tuple[int, int, int]:
    """(splits, split_pages, workspace pointer) of ``decode_plan``'s launch
    for these shapes."""
    B, Hq, D = q.shape
    Hkv = k_cache.shape[2]
    plan = decode_plan(B, Hkv, page_table.shape[1], D, Hq // Hkv)
    ws = workspace(q.device).data_ptr() if plan.splits > 1 else 0
    return plan.splits, plan.split_pages, ws


def mask_args(
    logit_cap: Optional[float], sliding_window: Optional[int], chunk_size: Optional[int] = None
) -> tuple[float, int, int]:
    """The kernels' runtime form of the cap, the window and the chunk: 0 for
    none, a window of ``GLOBAL_WINDOW`` or more included. A window and a
    chunk together are refused."""
    if logit_cap is not None and not logit_cap > 0:
        raise ValueError(f"logit_cap must be None or > 0, got {logit_cap}")
    if sliding_window is not None and sliding_window < 1:
        raise ValueError(f"sliding_window must be None or >= 1, got {sliding_window}")
    if chunk_size is not None and chunk_size < 1:
        raise ValueError(f"chunk_size must be None or >= 1, got {chunk_size}")
    if sliding_window is not None and sliding_window >= GLOBAL_WINDOW:
        sliding_window = None
    if sliding_window is not None and chunk_size is not None:
        raise ValueError(f"a window ({sliding_window}) and a chunk ({chunk_size}) in one call")
    return float(logit_cap or 0.0), int(sliding_window or 0), int(chunk_size or 0)


def sinks_arg(sinks: Optional[torch.Tensor], q: torch.Tensor) -> int:
    """The kernels' pointer to ``sinks`` (0 for none): contiguous f32
    ``[Hq]`` on q's device."""
    if sinks is None:
        return 0
    if sinks.dtype != torch.float32 or sinks.shape != (q.shape[1],) or not sinks.is_contiguous():
        raise ValueError(
            f"sinks must be contiguous f32 [{q.shape[1]}], got {sinks.dtype} {tuple(sinks.shape)}"
        )
    native.check_same_device(q, sinks)
    return sinks.data_ptr()


def softmax_with_sinks(
    scores: torch.Tensor, sinks: Optional[torch.Tensor], head_shape: tuple
) -> torch.Tensor:
    """softmax over the last axis of masked f32 ``scores``, with each
    head's sink logit (``sinks`` viewed as ``head_shape``, broadcast over the
    rest) in the denominator: ``xla_backend``'s concatenate-then-drop."""
    if sinks is None:
        return torch.softmax(scores, dim=-1)
    sk = sinks.float().reshape(head_shape).expand(scores.shape[:-1] + (1,))
    return torch.softmax(torch.cat([scores, sk], dim=-1), dim=-1)[..., :-1]


def softcap(scores: torch.Tensor, logit_cap: Optional[float]) -> torch.Tensor:
    """``cap * tanh(s / cap)``, as ``xla_backend._softcap``."""
    if logit_cap is None:
        return scores
    return logit_cap * torch.tanh(scores / logit_cap)


def gather_kv_rows(
    cache: torch.Tensor,  # [pages, ps, Hkv, D] one layer
    scale: Optional[torch.Tensor],  # [pages, ps, Hkv] or None
    slots: torch.Tensor,  # i64 flat slots, any shape
) -> torch.Tensor:
    """The rows at ``slots`` in f32 [..., Hkv, D]: bf16 values as they are,
    8-bit codes times their (token, head) scale."""
    Hkv, D = cache.shape[2], cache.shape[3]
    if scale is None:
        return cache.reshape(-1, Hkv, D)[slots].float()
    # gather bytes: not every indexing kernel takes float8
    codes = cache.view(torch.uint8).reshape(-1, Hkv, D)[slots].view(cache.dtype)
    return codes.float() * scale.reshape(-1, Hkv)[slots].float()[..., None]


def paged_decode_attention_plain(
    q: torch.Tensor,  # [B, Hq, D]
    k_cache: torch.Tensor,  # [pages, ps, Hkv, D] one layer
    v_cache: torch.Tensor,
    page_table: torch.Tensor,  # i32[B, P]
    seq_lens: torch.Tensor,  # i32[B]
    sm_scale: float,
    k_scale: Optional[torch.Tensor] = None,  # [pages, ps, Hkv] for 8-bit pages
    v_scale: Optional[torch.Tensor] = None,
    logit_cap: Optional[float] = None,
    sliding_window: Optional[int] = None,
    sinks: Optional[torch.Tensor] = None,  # f32 [Hq]
    chunk_size: Optional[int] = None,
) -> torch.Tensor:
    """Gather each row's pages into dense K/V (dequantized in f32 for 8-bit
    pages) and attend in f32, the cap, the window, the chunk and the sinks
    as in the module docstring. Rows with ``seq_len == 0`` give exact zeros,
    like the kernel."""
    _, sliding_window, chunk_size = (a or None for a in mask_args(logit_cap, sliding_window, chunk_size))
    B, Hq, D = q.shape
    _, ps, Hkv, _ = k_cache.shape
    G = Hq // Hkv
    P = page_table.shape[1]
    offs = torch.arange(ps, device=q.device)
    slots = (page_table.long()[:, :, None] * ps + offs).reshape(B, P * ps)
    k = gather_kv_rows(k_cache, k_scale, slots)  # [B, S, Hkv, D]
    v = gather_kv_rows(v_cache, v_scale, slots)
    qg = q.float().reshape(B, Hkv, G, D) * sm_scale
    scores = softcap(torch.einsum("bhgd,bshd->bhgs", qg, k), logit_cap)
    pos = torch.arange(P * ps, device=q.device)[None, :]
    valid = pos < seq_lens[:, None]
    if sliding_window is not None:
        valid &= pos >= seq_lens[:, None] - sliding_window
    if chunk_size is not None:
        valid &= pos >= (seq_lens[:, None] - 1).clamp(min=0) // chunk_size * chunk_size
    valid = valid[:, None, None, :]
    p = softmax_with_sinks(scores.masked_fill(~valid, float("-inf")), sinks, (1, Hkv, G, 1))
    p = torch.where(valid, p, torch.zeros((), device=q.device))  # len-0 rows
    out = torch.einsum("bhgs,bshd->bhgd", p, v)
    return out.reshape(B, Hq, D).to(q.dtype)


def check_pages(q, k_cache, v_cache, k_scale, v_scale, max_group: int) -> None:
    """What both attention kernels take: contiguous bf16 q and pages, or
    int8 / e4m3 pages with contiguous bf16 scales ``[pages, ps, Hkv]``;
    head_dim in ``HEAD_DIMS`` (bf16 and 8-bit pages alike);
    1..``max_group`` query heads per kv head."""
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                    ("k_scale", k_scale), ("v_scale", v_scale)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype != torch.bfloat16:
        raise TypeError(f"the attention kernels take bf16 q, got {q.dtype}")
    if k_cache.dtype != v_cache.dtype:
        raise TypeError(f"k_cache {k_cache.dtype} and v_cache {v_cache.dtype} differ")
    D = q.shape[-1]
    if k_cache.dim() != 4 or k_cache.shape != v_cache.shape or k_cache.shape[3] != D:
        raise ValueError(f"k/v caches must be [pages, ps, Hkv, {D}], got {tuple(k_cache.shape)}")
    if k_scale is None:
        if k_cache.dtype != torch.bfloat16:
            raise TypeError(f"bf16 pages expected, got {k_cache.dtype}")
    else:
        if k_cache.dtype not in CODE_TYPES:
            raise TypeError(f"8-bit pages must be int8 or float8_e4m3fn, got {k_cache.dtype}")
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            if t is None or t.dtype != SCALE_DTYPE:
                raise TypeError(f"{name} must be bf16, got {None if t is None else t.dtype}")
            if t.shape != k_cache.shape[:3]:
                raise ValueError(f"{name} must be {tuple(k_cache.shape[:3])}, got {tuple(t.shape)}")
    Hq, Hkv = q.shape[1], k_cache.shape[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {HEAD_DIMS}")
    if Hq % Hkv or not 1 <= Hq // Hkv <= max_group:
        raise ValueError(f"Hq={Hq} must be 1..{max_group} times Hkv={Hkv}")


def _check(q, k_cache, v_cache, k_scale, v_scale, page_table, seq_lens) -> None:
    check_pages(q, k_cache, v_cache, k_scale, v_scale, MAX_GROUP)
    for name, t in (("page_table", page_table), ("seq_lens", seq_lens)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    B = q.shape[0]
    if page_table.dim() != 2 or page_table.shape[0] != B or seq_lens.shape != (B,):
        raise ValueError("page_table must be [B, P] and seq_lens [B]")


def paged_decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    page_table: torch.Tensor,
    seq_lens: torch.Tensor,
    sm_scale: float,
    logit_cap: Optional[float] = None,
    sliding_window: Optional[int] = None,
    sinks: Optional[torch.Tensor] = None,
    chunk_size: Optional[int] = None,
) -> torch.Tensor:
    """out [B, Hq, D]: each row's single query over the live window (or
    chunk) of its ``seq_lens`` cached tokens in bf16 pages (see
    ``csrc/paged_decode_attention.cu``), split by ``decode_plan``."""
    native.check_same_device(q, k_cache, v_cache, page_table, seq_lens)
    if q.device.type == "cpu":
        return paged_decode_attention_plain(
            q, k_cache, v_cache, page_table, seq_lens, sm_scale,
            logit_cap=logit_cap, sliding_window=sliding_window, sinks=sinks, chunk_size=chunk_size,
        )
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: unsupported device {q.device}")
    masks = mask_args(logit_cap, sliding_window, chunk_size)
    _check(q, k_cache, v_cache, None, None, page_table, seq_lens)
    lib = native.load("paged_decode_attention", _SIGNATURES)
    out, rc = _launch_bf16(lib, q, k_cache, v_cache, page_table, seq_lens, sm_scale, masks,
                           sinks_arg(sinks, q), _plan_args(q, k_cache, page_table))
    if rc != 0:
        raise RuntimeError(f"paged_decode_attention launch failed: cudaError {rc}")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0


def _launch_bf16(lib, q, k_cache, v_cache, page_table, seq_lens, sm_scale, masks, sinks, split):
    """Launch ``lib``'s bf16 entry point with ``masks`` (``mask_args``) and
    the ``sinks`` pointer (0 for none) on ``split`` (``_plan_args``); (out,
    cudaError)."""
    B, Hq, D = q.shape
    out = torch.empty_like(q)
    rc = lib.paged_decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        page_table.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
        B, Hq, k_cache.shape[2], D, page_table.shape[1], k_cache.shape[1],
        float(sm_scale), *masks, sinks, *split, native.stream_handle(q.device),
    )
    return out, rc


# The decode kernel cut after a stage of its token loop, for the kernel-
# profiling tool (tools/decode_ablate.py); see csrc/paged_decode_attention.cu.
# Stage 4 is the production kernel, 5 that kernel carrying the cuts' V sum.
DECODE_STAGES = (1, 2, 3, 4, 5)
# the variant libraries of the cuts (stage 4 is the production library)
DECODE_STAGE_TARGETS = tuple(
    ("paged_decode_attention", {"SPTPU_DECODE_STAGE": s}) for s in DECODE_STAGES if s != 4
)


def paged_decode_attention_stage_plain(
    stage, q, k_cache, v_cache, page_table, seq_lens, sm_scale
) -> torch.Tensor:
    """f32 ``[B, Hq, D]``: what the decode kernel cut after ``stage`` writes,
    over the n live tokens t of each row, with ``s = sm_scale q . K[t]`` and
    query head ``h`` on kv head ``h // G``; rows with ``seq_len == 0`` are
    zeros:

    1. ``sum_t (|K[t]| + |V[t]|)``;
    2. ``sum_t |s(t)| + sum_t |V[t]|``;
    3. ``|m| + (sum_t |V[t]|) / l``, ``m = max_t s``, ``l = sum_t exp(s - m)``;
    4. the decode itself (``paged_decode_attention_plain``);
    5. the decode plus ``(sum_t |V[t]|) / n``.
    """
    if stage not in DECODE_STAGES:
        raise ValueError(f"stage {stage} not in {DECODE_STAGES}")
    if stage == 4:
        return paged_decode_attention_plain(q.float(), k_cache, v_cache, page_table, seq_lens,
                                            sm_scale)
    B, Hq, D = q.shape
    _, ps, Hkv, _ = k_cache.shape
    G = Hq // Hkv
    P = page_table.shape[1]
    slots = (page_table.long()[:, :, None] * ps + torch.arange(ps, device=q.device)).reshape(B, -1)
    k = gather_kv_rows(k_cache, None, slots)  # [B, S, Hkv, D] f32
    v = gather_kv_rows(v_cache, None, slots)
    valid = (torch.arange(P * ps, device=q.device)[None, :] < seq_lens[:, None])[..., None, None]
    vsum = torch.where(valid, v.abs(), 0.0).sum(1)[:, :, None]  # [B, Hkv, 1, D]
    live_rows = (seq_lens > 0)[:, None, None, None]
    if stage == 1:
        out = (vsum + torch.where(valid, k.abs(), 0.0).sum(1)[:, :, None]).expand(B, Hkv, G, D)
    elif stage == 5:
        full = paged_decode_attention_plain(q.float(), k_cache, v_cache, page_table, seq_lens,
                                            sm_scale).reshape(B, Hkv, G, D)
        n = seq_lens.clamp(min=1).float()[:, None, None, None]
        out = torch.where(live_rows, full + vsum / n, 0.0)
    else:
        qg = q.float().reshape(B, Hkv, G, D) * sm_scale
        s = torch.einsum("bhgd,bshd->bhgs", qg, k)
        live = valid[..., 0, 0][:, None, None, :]  # [B, 1, 1, S]
        if stage == 2:
            out = torch.where(live, s.abs(), 0.0).sum(-1)[..., None] + vsum
        else:
            s = s.masked_fill(~live, float("-inf"))
            m = s.amax(-1)
            l = torch.exp(s - m[..., None]).sum(-1)
            out = torch.where(live_rows, m.abs()[..., None] + vsum / l[..., None], 0.0)
    return out.reshape(B, Hq, D).contiguous()


def paged_decode_attention_stage(
    stage, q, k_cache, v_cache, page_table, seq_lens, sm_scale
) -> torch.Tensor:
    """The decode kernel cut after ``stage`` (bf16 ``[B, Hq, D]``, bf16
    pages, no cap or window, one split) for CUDA tensors, from its variant library
    (``DECODE_STAGE_TARGETS``); ``paged_decode_attention_stage_plain`` for
    CPU tensors. Stage 4 is ``paged_decode_attention`` and counts as its
    launch; this count holds the cuts' launches."""
    native.check_same_device(q, k_cache, v_cache, page_table, seq_lens)
    if q.device.type == "cpu":
        return paged_decode_attention_stage_plain(stage, q, k_cache, v_cache, page_table,
                                                  seq_lens, sm_scale)
    if stage not in DECODE_STAGES:
        raise ValueError(f"stage {stage} not in {DECODE_STAGES}")
    if stage == 4:
        return paged_decode_attention(q, k_cache, v_cache, page_table, seq_lens, sm_scale)
    _check(q, k_cache, v_cache, None, None, page_table, seq_lens)
    lib = native.load("paged_decode_attention", _SIGNATURES, {"SPTPU_DECODE_STAGE": stage})
    one_split = (1, max(1, page_table.shape[1]), 0)
    out, rc = _launch_bf16(lib, q, k_cache, v_cache, page_table, seq_lens, sm_scale, (0.0, 0, 0), 0,
                           one_split)
    if rc != 0:
        raise RuntimeError(f"decode stage {stage} launch failed: cudaError {rc} (the cuts take "
                           "bf16 pages at G 3 and 4, D 64 and 128, one split)")
    paged_decode_attention_stage.launches += 1
    return out


paged_decode_attention_stage.launches = 0


def paged_decode_attention_quant(
    q: torch.Tensor,
    k_cache: torch.Tensor,  # int8 | float8_e4m3fn [pages, ps, Hkv, D]
    v_cache: torch.Tensor,
    k_scale: torch.Tensor,  # bf16 [pages, ps, Hkv]
    v_scale: torch.Tensor,
    page_table: torch.Tensor,
    seq_lens: torch.Tensor,
    sm_scale: float,
    logit_cap: Optional[float] = None,
    sliding_window: Optional[int] = None,
    sinks: Optional[torch.Tensor] = None,
    chunk_size: Optional[int] = None,
) -> torch.Tensor:
    """``paged_decode_attention`` over 8-bit pages: the kernel folds the
    scales out of its dots, s = (q . k_code) s_k and p' = p s_v; the cap
    applies to that s."""
    native.check_same_device(q, k_cache, v_cache, k_scale, v_scale, page_table, seq_lens)
    if q.device.type == "cpu":
        return paged_decode_attention_plain(
            q, k_cache, v_cache, page_table, seq_lens, sm_scale, k_scale, v_scale,
            logit_cap, sliding_window, sinks, chunk_size,
        )
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention_quant: unsupported device {q.device}")
    masks = mask_args(logit_cap, sliding_window, chunk_size)
    _check(q, k_cache, v_cache, k_scale, v_scale, page_table, seq_lens)
    lib = native.load("paged_decode_attention", _SIGNATURES)
    B, Hq, D = q.shape
    out = torch.empty_like(q)
    rc = lib.paged_decode_attention_quant(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        k_scale.data_ptr(), v_scale.data_ptr(),
        page_table.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
        B, Hq, k_cache.shape[2], D, page_table.shape[1], k_cache.shape[1],
        CODE_TYPES[k_cache.dtype], float(sm_scale), *masks, sinks_arg(sinks, q),
        *_plan_args(q, k_cache, page_table), native.stream_handle(q.device),
    )
    if rc != 0:
        raise RuntimeError(f"paged_decode_attention_quant launch failed: cudaError {rc}")
    paged_decode_attention_quant.launches += 1
    return out


paged_decode_attention_quant.launches = 0


def decode_attention_gqa(
    q: torch.Tensor,  # [B, Hq, D]
    kv: KVCache,
    layer_idx: int,
    meta: ForwardMeta,
    *,
    sm_scale: float,
    logit_cap: Optional[float] = None,
    sliding_window: Optional[int] = None,
    sinks: Optional[torch.Tensor] = None,
    chunk_size: Optional[int] = None,
) -> torch.Tensor:
    """Model-facing decode attention over one layer of the pool (the
    ``attention_backend="auto"`` decode)."""
    k, v, k_scale, v_scale = kv.layer(layer_idx)
    if k_scale is None:
        return paged_decode_attention(
            q, k, v, meta.page_table, meta.seq_lens, sm_scale, logit_cap, sliding_window, sinks,
            chunk_size,
        )
    return paged_decode_attention_quant(
        q, k, v, k_scale, v_scale, meta.page_table, meta.seq_lens, sm_scale,
        logit_cap, sliding_window, sinks, chunk_size,
    )
