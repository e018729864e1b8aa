"""Device-side sampler: penalties + top-k/top-p/min-p + categorical draw.

Counterpart of ``scratchpad_tpu/sampling/sampler.py`` in PyTorch, with the
same sort-free filter: top-k, top-p and min-p reduce to one per-row cutoff
in scaled-logit space, found by a joint multi-way bisection
(``_fused_cutoff``, 2 taps x 10 iterations by default), so no full-vocab
sort runs per step. Random draws use an explicit ``torch.Generator``
(Gumbel-max, the same construction as ``jax.random.categorical``); the bits
differ from JAX's, so tests compare sampled output as a distribution.
A grammar's allow-mask (``apply_vocab_bitmask``) bans logits after the
penalties and before the filters, as the JAX sampler does. Custom logit
processors (``sampling/custom_logit_processor.py``) run first of all, each
on the whole batch, their rows blended back by mask (JAX
``sampler.py:174-186``).
"""

from __future__ import annotations

import os

import torch

from scratchpad_tpu_torch.sampling.batch_info import SamplingBatchInfo

_NEG = -1e30
_BISECT_TAPS = int(os.environ.get("SPTPU_BISECT_TAPS", "2"))
_BISECT_ITERS = int(os.environ.get("SPTPU_BISECT_ITERS", "10"))
# softmax tail below z = max - 80 underflows f32: those tokens can never be
# drawn, so the bisection domain is clamped there
_Z_FLOOR = -80.0


def _fused_cutoff(
    scaled: torch.Tensor,  # f32[B, V] temperature-scaled logits
    top_k: torch.Tensor,  # i32[B] (V = disabled)
    top_p: torch.Tensor,  # f32[B] (1.0 = disabled)
    min_p: torch.Tensor,  # f32[B] (0.0 = disabled)
    taps: int | None = None,
    iters: int | None = None,
) -> torch.Tensor:
    """Joint top-k/top-p/min-p cutoff in scaled-logit space, f32[B, 1].

    Keeping ``scaled >= cutoff`` reproduces the intersection of the three
    filters without sorting:
      top-k   cutoff = k-th largest logit           (count-above bisection)
      top-p   cutoff = largest t with mass(>=t)>=p  (mass-above bisection)
      min-p   cutoff = max + log(min_p)             (analytic)
    """
    taps = _BISECT_TAPS if taps is None else taps
    iters = _BISECT_ITERS if iters is None else iters
    B, V = scaled.shape
    rowmax = scaled.max(dim=-1, keepdim=True).values
    z = scaled - rowmax  # <= 0; banned entries ~ -1e30
    valid = z > -1e29
    e = torch.where(valid, torch.exp(z), torch.zeros((), device=z.device))
    Z = e.sum(dim=-1, keepdim=True)

    zmin = torch.where(valid, z, torch.zeros((), device=z.device)).min(
        dim=-1, keepdim=True
    ).values
    lo0 = torch.clamp(zmin, min=_Z_FLOOR) - 1e-3  # keep-everything side
    hi0 = torch.full_like(lo0, 1e-3)  # keep-nothing side (> rowmax)

    k = torch.clamp(top_k, 1, V).float()[:, None]
    p_target = torch.clamp(top_p, 1e-9, 1.0)[:, None] * Z

    grid = torch.arange(1, taps + 1, device=z.device, dtype=torch.float32) / (taps + 1)
    lo_k = lo_p = lo0
    hi_k = hi_p = hi0
    for _ in range(iters):
        mid_k = lo_k + (hi_k - lo_k) * grid[None, :]  # [B, S]
        mid_p = lo_p + (hi_p - lo_p) * grid[None, :]
        cnt = (z[:, :, None] >= mid_k[:, None, :]).float().sum(dim=1)  # [B, S]
        mass = torch.where(
            z[:, :, None] >= mid_p[:, None, :], e[:, :, None], 0.0
        ).sum(dim=1)
        ok_k = cnt >= k  # monotone: True then False along the grid
        ok_p = mass >= p_target
        lo_k = torch.where(ok_k, mid_k, lo_k).max(dim=1, keepdim=True).values
        hi_k = torch.where(ok_k, hi_k, mid_k).min(dim=1, keepdim=True).values
        lo_p = torch.where(ok_p, mid_p, lo_p).max(dim=1, keepdim=True).values
        hi_p = torch.where(ok_p, hi_p, mid_p).min(dim=1, keepdim=True).values

    ninf = torch.tensor(float("-inf"), device=z.device)
    # top_k == 1 is argmax: the cutoff is the row max itself (z = 0)
    c_k = torch.where(top_k[:, None] == 1, torch.zeros((), device=z.device), lo_k)
    c_k = torch.where(top_k[:, None] < V, c_k, ninf)
    c_p = torch.where(top_p[:, None] < 1.0, lo_p, ninf)
    c_m = torch.where(
        min_p[:, None] > 0.0, torch.log(torch.clamp(min_p[:, None], min=1e-30)), ninf
    )
    return torch.maximum(torch.maximum(c_k, c_p), c_m) + rowmax


def apply_penalties(logits: torch.Tensor, info: SamplingBatchInfo) -> torch.Tensor:
    """Presence/frequency/repetition penalties."""
    if info.output_token_counts is None:
        return logits
    counts = info.output_token_counts.float()
    logits = logits - info.frequency_penalty[:, None] * counts
    logits = logits - info.presence_penalty[:, None] * (counts > 0).float()
    # repetition penalty applies to prompt + generated tokens
    seen = (counts > 0) | info.input_token_mask
    rep = info.repetition_penalty[:, None]
    penalized = torch.where(logits > 0, logits / rep, logits * rep)
    return torch.where(seen, penalized, logits)


_BIT_INDEX: dict[tuple, tuple[torch.Tensor, torch.Tensor]] = {}


def _bit_index(vocab_size: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Each token's mask word and bit, built once a vocab size and device."""
    key = (vocab_size, str(device))
    idx = _BIT_INDEX.get(key)
    if idx is None:
        ids = torch.arange(vocab_size, device=device, dtype=torch.int64)
        idx = _BIT_INDEX[key] = (ids // 32, (ids % 32).to(torch.int32))
    return idx


def apply_vocab_bitmask(logits: torch.Tensor, bitmask: torch.Tensor) -> torch.Tensor:
    """Mask logits [B, V] with a packed u32 allow-mask [B, ceil(V / 32)]
    (bit t % 32 of word t // 32 allows token t; int32 words of the same
    bits are taken too): a banned logit becomes ``_NEG``. The JAX
    ``sampler.apply_vocab_bitmask``; no Pallas kernel there, torch ops
    here."""
    word, bit = _bit_index(logits.shape[1], logits.device)
    if bitmask.dtype != torch.int32:
        bitmask = bitmask.view(torch.int32)
    allowed = (bitmask[:, word] >> bit) & 1
    return torch.where(allowed.bool(), logits, _NEG)


def sample(
    logits: torch.Tensor,  # f32[B, V]
    info: SamplingBatchInfo,  # tensors on logits.device
    generator: torch.Generator | None,
    full_logprobs: bool = True,
    modes: tuple[bool, bool] | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (token ids i64[B], logprobs): the full post-penalty f32[B, V]
    log-softmax, or with ``full_logprobs=False`` just the chosen token's
    logprob f32[B]. Order: custom processors -> logit bias -> penalties ->
    grammar mask -> temperature -> top-k -> top-p -> min-p -> categorical.

    ``modes`` is (any row samples, any row filters), known on the host
    before the batch moved to the device (``SamplingBatchInfo.modes``); the
    greedy hot path then skips the draw without a device sync. ``None``
    reads both from ``info``."""
    B, V = logits.shape
    if info.custom_processors:
        for i, proc in enumerate(info.custom_processors):
            params = info.custom_proc_params[i] if info.custom_proc_params is not None else {}
            # a copy: a processor that writes in place must not reach the
            # rows that the blend keeps (other requests, padding)
            out = proc(logits.clone(), params)
            logits = torch.where(info.custom_proc_mask[i][:, None], out, logits)
    if info.logit_bias is not None:
        logits = logits + info.logit_bias
    logits = apply_penalties(logits, info)
    if info.vocab_bitmask is not None:
        logits = apply_vocab_bitmask(logits, info.vocab_bitmask)
    ids = torch.argmax(logits, dim=-1)
    if modes is None:
        modes = SamplingBatchInfo.modes(info, V)
    any_sampling, need_filter = modes
    if any_sampling:
        temp = torch.clamp(info.temperature, min=1e-6)[:, None]
        scaled = logits / temp
        if need_filter:
            cutoff = _fused_cutoff(scaled, info.top_k, info.top_p, info.min_p)
            scaled = torch.where(scaled >= cutoff, scaled, _NEG)
        u = torch.rand(
            (B, V), generator=generator, device=logits.device, dtype=torch.float32
        )
        gumbel = -torch.log(-torch.log(u.clamp_(min=1e-20)))
        drawn = torch.argmax(scaled + gumbel, dim=-1)
        ids = torch.where(info.temperature > 0.0, drawn, ids)
    if full_logprobs:
        return ids, torch.log_softmax(logits, dim=-1)
    chosen = logits.gather(1, ids[:, None])[:, 0] - torch.logsumexp(logits, dim=-1)
    return ids, chosen
