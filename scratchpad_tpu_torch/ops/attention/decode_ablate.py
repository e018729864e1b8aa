"""The decode ablation probe: the CUDA kernel's wrapper and its plain version.

Counterpart of ``tools/profiling/_ablate.py::make_kernel`` (``:11-89``), the
JAX package's Pallas probe that cuts a paged flash-decode after one of five
stages (``MODES``) to time each; ``csrc/decode_ablate.cu`` is its hand-written
CUDA kernel. It lies on no serving path: ``tools/decode_ablate.py`` times it.

The pool is interleaved, ``kv [pages, ps, 2 Hkv, Dp]``: lane block ``2k``
is K of kv head ``k`` and ``2k + 1`` its V. ``decode_ablate_plain`` defines
the function element for element, the JAX kernel's statistic and the
``aux`` that shows each stage's own work; the kernel's source says the
same in prose. Two outputs:

- ``out [B, Hq, Dp]`` bf16, the JAX kernel's ``m + l + acc[:1, :1]``
  broadcast over the row. In ``dma_only``, ``reshape_only`` and
  ``sdot_only`` its ``m`` stays ``-1e30``, so every row reads ``-1e30``
  whatever was loaded; in ``full`` its ``acc[0, 0]`` is head 0's PV taken
  over all lanes, which hides the real PV. Hence:
- ``aux [B, Hq, 3]`` f32: ``m``, ``l`` and a checksum of the stage's work
  (see ``decode_ablate_plain``).

``decode_ablate`` takes the plain version for CPU tensors and launches the
kernel for CUDA tensors, raising on anything the kernel does not take; it
never falls back.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from scratchpad_tpu_torch.utils import native

MODES = ("dma_only", "reshape_only", "sdot_only", "no_pv", "full")
NEG = -1e30  # _ablate.py's _NEG: the mask value and m's start
HEAD_DIMS = (64, 128)
GROUPS = (1, 2, 3, 4, 8)  # query heads per kv head the kernel is built for

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "decode_ablate": ([_P] * 7 + [ctypes.c_int] * 8 + [_P], ctypes.c_int),
    "decode_ablate_smem_bytes": ([_I] * 5, ctypes.c_int),
}


def num_chunks(seq_lens: torch.Tensor, chunk: int) -> torch.Tensor:
    """Chunks a row streams: ``max(ceil(len / chunk), 1)`` (``_ablate.py:23``)."""
    return torch.clamp((seq_lens.long() + chunk - 1) // chunk, min=1)


def lane_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``sum(a * b, -1)`` in f32 in the kernel's order: ``min(32, D)`` lanes
    each sum ``D / lanes`` consecutive products in turn, then the lanes
    combine in a butterfly (halves first). Products of bf16 values are exact
    in f32, so the kernel's fused multiply-adds round as these adds do, and
    the scores (hence ``m``) come out bit for bit."""
    prod = a.float() * b.float()
    D = prod.shape[-1]
    lanes = min(32, D)
    prod = prod.reshape(*prod.shape[:-1], lanes, D // lanes)
    acc = prod[..., 0]
    for e in range(1, prod.shape[-1]):
        acc = acc + prod[..., e]
    while acc.shape[-1] > 1:
        half = acc.shape[-1] // 2
        acc = acc[..., :half] + acc[..., half:]
    return acc[..., 0]


def _check_args(q, kv, page_table, seq_lens, mode, chunk_pages) -> None:
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    if q.dim() != 3 or kv.dim() != 4 or kv.shape[3] != q.shape[2] or kv.shape[2] % 2:
        raise ValueError(
            f"q must be [B, Hq, Dp] and kv [pages, ps, 2 Hkv, Dp], got {tuple(q.shape)} "
            f"and {tuple(kv.shape)}"
        )
    Hkv = kv.shape[2] // 2
    if Hkv == 0 or q.shape[1] % Hkv:
        raise ValueError(f"Hq={q.shape[1]} must be a multiple of Hkv={Hkv}")
    B = q.shape[0]
    if page_table.dim() != 2 or page_table.shape[0] != B or seq_lens.shape != (B,):
        raise ValueError("page_table must be [B, P] and seq_lens [B]")
    if chunk_pages < 1:
        raise ValueError(f"chunk_pages must be >= 1, got {chunk_pages}")


def _check_table(page_table, max_len: int, chunk: int, chunk_pages: int) -> None:
    """Every chunk reads all of its CP page-table entries (``_ablate.py:26``)."""
    need = max(-(-max_len // chunk), 1) * chunk_pages
    if page_table.shape[1] < need:
        raise ValueError(
            f"page_table has {page_table.shape[1]} entries a row; a row of {max_len} tokens "
            f"reads {need} ({chunk_pages}-page chunks)"
        )


def decode_ablate_plain(
    q: torch.Tensor,  # [B, Hq, Dp] bf16
    kv: torch.Tensor,  # [pages, ps, 2 Hkv, Dp] bf16
    page_table: torch.Tensor,  # i32 [B, P]
    seq_lens: torch.Tensor,  # i32 [B]
    mode: str,
    chunk_pages: int = 16,
    max_seq_len: Optional[int] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(out [B, Hq, Dp] bf16, aux [B, Hq, 3] f32)`` in f32 arithmetic.

    Per row b, over chunks of ``CP = chunk_pages`` pages (``CHUNK = CP ps``
    rows; ``max(ceil(len / CHUNK), 1)`` chunks, each reading all CP table
    entries), with query head ``h`` on kv head ``k = h // G``:

    - ``s[h, j] = q[h] . K_k[j]`` (``lane_dot``; no ``sm_scale``);
    - ``no_pv``, ``full``: rows ``j >= len`` masked to -1e30, then per chunk
      ``m' = max(m, max s)``, ``alpha = exp(m - m')``, ``p = exp(s - m')``,
      ``l = l alpha + sum p``; ``full`` also ``acc = acc alpha +
      bf16(p) . V_k`` (``_ablate.py:68-78``); ``m`` starts at -1e30, so a
      row with ``len == 0`` ends with ``m = -1e30``, ``l = CHUNK``;
    - ``out[h, :] = bf16((m + l) + acc00)``, with ``acc00`` the JAX
      kernel's ``acc[0, 0]``: the chunks' first element of K_0 summed
      (``dma_only``), K_0's column 0 summed (``reshape_only``), 0
      (``sdot_only``, ``no_pv``), ``acc00 alpha_0 + bf16(p[0]) . K_0[:, 0]``
      (``full``);
    - ``aux[h] = (m, l, checksum)``: ``m`` -1e30 and ``l`` 0 until
      ``sdot_only``, whose ``l`` is the sum of all its scores (JAX's); the
      checksum is ``dma_only``: element ``[row 0, d 0]`` of K_k's first page
      of each chunk, summed; ``reshape_only``: the sum of ``|x|`` over every
      element of K_k and V_k in the chunks; ``sdot_only``: the sum of
      ``|s|`` over their rows; ``no_pv``: 0; ``full``: ``sum_d |acc[h, d]|``.
      The magnitudes keep a checksum from cancelling to near 0, where its
      f32 rounding would pass a tolerance relative to its value.

    ``max_seq_len``, the longest row, spares reading ``seq_lens`` on the
    host (a device sync for CUDA tensors); a table too narrow for it raises.
    """
    _check_args(q, kv, page_table, seq_lens, mode, chunk_pages)
    B, Hq, Dp = q.shape
    _, ps, H2, _ = kv.shape
    Hkv = H2 // 2
    G = Hq // Hkv
    CP = chunk_pages
    CHUNK = CP * ps
    dev = q.device
    lens = seq_lens.long()
    nch = num_chunks(seq_lens, CHUNK)
    if max_seq_len is None:
        max_seq_len = int(lens.max()) if B else 0
    _check_table(page_table, max_seq_len, CHUNK, CP)
    C = max(-(-max_seq_len // CHUNK), 1) if B else 0
    kv_of = torch.arange(Hq, device=dev) // G
    m = torch.full((B, Hq), NEG, dtype=torch.float32, device=dev)
    l = torch.zeros(B, Hq, dtype=torch.float32, device=dev)
    chk = torch.zeros(B, Hq, dtype=torch.float32, device=dev)
    acc = torch.zeros(B, Hq, Dp, dtype=torch.float32, device=dev)
    acc00 = torch.zeros(B, dtype=torch.float32, device=dev)
    qf = q.float()
    for c in range(C):
        live = (c < nch)[:, None]  # [B, 1]
        pages = page_table[:, c * CP : (c + 1) * CP].long()
        rows = kv[pages].reshape(B, CHUNK, Hkv, 2, Dp).float()
        K, V = rows[:, :, :, 0], rows[:, :, :, 1]  # [B, CHUNK, Hkv, Dp]
        if mode == "dma_only":
            first = K[:, 0, :, 0]  # [B, Hkv]
            chk = torch.where(live, chk + first[:, kv_of], chk)
            acc00 = torch.where(live[:, 0], acc00 + first[:, 0], acc00)
            continue
        if mode == "reshape_only":
            total = (K.abs() + V.abs()).sum(dim=(1, 3))  # [B, Hkv]
            chk = torch.where(live, chk + total[:, kv_of], chk)
            acc00 = torch.where(live[:, 0], acc00 + K[:, :, 0, 0].sum(1), acc00)
            continue
        s = lane_dot(qf[:, None], K[:, :, kv_of]).transpose(1, 2)  # [B, Hq, CHUNK]
        col = c * CHUNK + torch.arange(CHUNK, device=dev)
        valid = col[None, None, :] < lens[:, None, None]
        if mode == "sdot_only":
            l = torch.where(live, l + s.sum(-1), l)
            chk = torch.where(live, chk + s.abs().sum(-1), chk)
            continue
        s = torch.where(valid, s, torch.full((), NEG, device=dev))
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l_new = l * alpha + p.sum(-1)
        if mode == "full":
            pq = p.to(torch.bfloat16).float()
            pv = torch.einsum("bhj,bhjd->bhd", pq, V[:, :, kv_of].transpose(1, 2))
            acc = torch.where(live[..., None], acc * alpha[..., None] + pv, acc)
            pk = (pq[:, 0] * K[:, :, 0, 0]).sum(-1)
            acc00 = torch.where(live[:, 0], acc00 * alpha[:, 0] + pk, acc00)
        m = torch.where(live, m_new, m)
        l = torch.where(live, l_new, l)
    if mode == "full":
        chk = acc.abs().sum(-1)
    stat = ((m + l) + acc00[:, None]).to(torch.bfloat16)
    out = stat[..., None].expand(B, Hq, Dp).contiguous()
    return out, torch.stack([m, l, chk], dim=-1)


# aux is never rounded to bf16: kernel and plain version differ only in the
# order of their f32 sums, by under 2e-6 of a value (NVIDIA H100, PERF.md)
AUX_RTOL = 2.0**-12


def aux_tolerance(ref_aux: torch.Tensor, mode: str, atol: float) -> torch.Tensor:
    """Elementwise tolerance of the kernel's ``aux`` against the plain
    version's ``ref_aux``: ``m`` exact (0), since both take the same scores
    (``lane_dot``) and a max does not round; ``l`` and the checksum ``atol +
    AUX_RTOL |ref|``. ``AUX_RTOL`` is 16 times tighter than a bf16 rounding,
    so that a checksum of magnitudes still sees a page read from the wrong
    place. ``sdot_only``'s ``l``, JAX's signed sum of the scores, can cancel
    to near 0 while its rounding scales with the sum of ``|s|``, that mode's
    checksum: it gets ``AUX_RTOL`` of that too."""
    tol = atol + AUX_RTOL * ref_aux.abs()
    tol[..., 0] = 0.0
    if mode == "sdot_only":
        tol[..., 1] += AUX_RTOL * ref_aux[..., 2]
    return tol


def _check_kernel_args(q, kv, page_table, seq_lens) -> None:
    for name, t in (("q", q), ("kv", kv), ("page_table", page_table), ("seq_lens", seq_lens)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("q", q), ("kv", kv)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name} must be bf16, got {t.dtype}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    for name, t in (("page_table", page_table), ("seq_lens", seq_lens)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    Dp, Hq, Hkv = q.shape[2], q.shape[1], kv.shape[2] // 2
    if Dp not in HEAD_DIMS:
        raise ValueError(f"Dp {Dp} not in {HEAD_DIMS}")
    if Hq // Hkv not in GROUPS:
        raise ValueError(f"Hq={Hq} must be {GROUPS} times Hkv={Hkv}")


def decode_ablate(
    q: torch.Tensor,
    kv: torch.Tensor,
    page_table: torch.Tensor,
    seq_lens: torch.Tensor,
    mode: str,
    chunk_pages: int = 16,
    max_seq_len: Optional[int] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(out, aux)`` of ``decode_ablate_plain``, from the CUDA kernel for
    CUDA tensors. A page table narrower than a row's ``nchunks * CP``
    entries is refused; ``max_seq_len``, the longest row, spares the read
    of ``seq_lens`` that this check otherwise costs on the card (a device
    sync). Should it understate, the kernel reads no entry past the table
    and gives that row NaN."""
    native.check_same_device(q, kv, page_table, seq_lens)
    if q.device.type == "cpu":
        return decode_ablate_plain(q, kv, page_table, seq_lens, mode, chunk_pages, max_seq_len)
    if q.device.type != "cuda":
        raise ValueError(f"decode_ablate: unsupported device {q.device}")
    _check_args(q, kv, page_table, seq_lens, mode, chunk_pages)
    _check_kernel_args(q, kv, page_table, seq_lens)
    B, Hq, Dp = q.shape
    ps, Hkv = kv.shape[1], kv.shape[2] // 2
    if max_seq_len is None:
        max_seq_len = int(seq_lens.max()) if B else 0
    _check_table(page_table, max_seq_len, chunk_pages * ps, chunk_pages)
    lib = native.load("decode_ablate", _SIGNATURES)
    if lib.decode_ablate_smem_bytes(Hq, Hkv, Dp, ps, chunk_pages) == 0:
        raise ValueError(
            f"page_size {ps} x chunk_pages {chunk_pages} at Dp {Dp}, G {Hq // Hkv} needs more "
            "than the card's 227 KB of shared memory a CTA"
        )
    out = torch.empty_like(q)
    aux = torch.empty(B, Hq, 3, dtype=torch.float32, device=q.device)
    acc00 = torch.empty(B, dtype=torch.float32, device=q.device)
    rc = lib.decode_ablate(
        q.data_ptr(), kv.data_ptr(), page_table.data_ptr(), seq_lens.data_ptr(),
        out.data_ptr(), aux.data_ptr(), acc00.data_ptr(), B, Hq, Hkv, Dp,
        page_table.shape[1], ps, chunk_pages, MODES.index(mode),
        native.stream_handle(q.device),
    )
    if rc != 0:
        raise RuntimeError(f"decode_ablate launch failed: cudaError {rc}")
    decode_ablate.launches += 1
    return out, aux


decode_ablate.launches = 0
