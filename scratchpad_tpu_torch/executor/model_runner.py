"""ModelRunner: owns the model, the paged KV pool, the allocators and the step.

Counterpart of ``scratchpad_tpu/executor/model_runner.py``, for the part the
port has: parameter and KV-pool sizing, ``run_extend`` and the fused decode
window (``run_decode_window`` / ``decode_multi``). PyTorch runs eagerly: a
step is the model's forward followed by ``sample``, and a decode window is a
loop of K steps whose sampled ids stay on the device and feed the next step,
with one host fetch per window. Decode batches are padded to the
batch-size buckets that CUDA graphs will be captured at (later work), so
their padding rows reach the decode kernel as they will then; an extend
batch runs at its real size, since nothing is compiled for its shape.

Attention runs through the kernel wrappers that ``attention_backend``
names (``auto`` or ``pallas``), which launch the hand-written CUDA kernels
for CUDA tensors and take their plain PyTorch versions for CPU tensors. ``attach_toppings`` hands a ``ToppingsManager``'s device pools to
the model; a batch that names adapters then carries its slot table in the
same upload buffer as the rest of its integers.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Any, Optional

import numpy as np
import torch

from scratchpad_tpu_torch.config import ModelConfig, ServerArgs
from scratchpad_tpu_torch.executor.forward_meta import ForwardMeta, ForwardMode
from scratchpad_tpu_torch.executor.weight_loader import load_hf_state, quantized_layer_state
from scratchpad_tpu_torch.memory import (
    KVCacheConfig,
    PageAllocator,
    ReqSlotAllocator,
    create_kv_cache,
)
from scratchpad_tpu_torch.memory.kv_cache import QUANT_KV_DTYPES
from scratchpad_tpu_torch.models.registry import get_model_class
from scratchpad_tpu_torch.ops.attention import attention_functions
from scratchpad_tpu_torch.ops.quant.import_hf import convert_quantized_layers, split_quant_tensors
from scratchpad_tpu_torch.sampling.batch_info import SamplingBatchInfo
from scratchpad_tpu_torch.sampling.sampler import sample
from scratchpad_tpu_torch.utils import get_logger

logger = get_logger("model_runner")

_DTYPES = {
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float16": torch.float16,
}


@dataclasses.dataclass
class WorkerBatch:
    """Host-side batch handed from the scheduler. The runner refuses a
    batch that sets a field of ``_UNPORTED_BATCH_FIELDS``: features the port
    does not have yet."""

    mode: ForwardMode
    tokens: np.ndarray  # i32[T_real]
    positions: np.ndarray  # i32[T_real]
    out_cache_loc: np.ndarray  # i32[T_real]
    req_indices: np.ndarray  # i32[T_real]
    page_table: np.ndarray  # i32[B_real, P_real]
    seq_lens: np.ndarray  # i32[B_real]
    extend_lens: np.ndarray  # i32[B_real]
    sampling_info: SamplingBatchInfo  # arrays sized B_real (padded by runner)
    vocab_bitmask: Optional[np.ndarray] = None
    return_top_logprobs: bool = False
    active_adapters: Optional[np.ndarray] = None
    adapter_slots: Optional[np.ndarray] = None
    input_embeds: Optional[np.ndarray] = None
    mrope_positions: Optional[np.ndarray] = None
    rope_delta: Optional[np.ndarray] = None
    mm_spans: Optional[np.ndarray] = None


_UNPORTED_BATCH_FIELDS = (
    "vocab_bitmask",
    "input_embeds",
    "mrope_positions",
    "rope_delta",
    "mm_spans",
)


def _next_bucket(ladder: list[int], n: int) -> int:
    for b in ladder:
        if b >= n:
            return b
    return ladder[-1]


def _pow2_bucket(n: int, lo: int, hi: int) -> int:
    b = lo
    while b < n and b < hi:
        b *= 2
    return min(b, hi)


# quantization -> the model's route: w4a8, or w4a16 for every other W4 name
_QUANT_ROUTE = {
    "w4a8": "w4a8", "w4a16": "w4a16", "w4": "w4a16",
    "awq": "w4a16", "gptq": "w4a16", "gptq_v2": "w4a16",
}


def resolve_kv_cache_dtype(args: ServerArgs, cfg: ModelConfig, device: torch.device) -> str:
    """The KV pool's dtype: ``int8`` or ``fp8`` (8-bit codes with per-(token,
    head) bf16 scales), or the model dtype. ``auto`` follows the JAX
    runner's model-aware rule (``model_runner.py:207-222``): int8 KV for
    W4-quantized serving on an accelerator through the ``auto`` backend (the
    JAX runner's ``gqa``) when hidden x layers >= 50,000 (3B and up);
    otherwise, as an explicit ``bfloat16`` does, the pool takes the model
    dtype. Unlike the JAX runner it leaves ``args`` as it is."""
    if args.kv_cache_dtype in QUANT_KV_DTYPES:
        return args.kv_cache_dtype
    if (
        args.kv_cache_dtype == "auto"
        and args.attention_backend == "auto"
        and args.quantization in ("w4a8", "w4a16", "awq", "gptq")
        and device.type == "cuda"
        and cfg.hidden_size * cfg.num_hidden_layers >= 50_000
    ):
        logger.info(
            "kv_cache_dtype auto -> int8 (quantized serving, hidden x layers = %d; "
            "set kv_cache_dtype='bfloat16' to force full-precision KV)",
            cfg.hidden_size * cfg.num_hidden_layers,
        )
        return "int8"
    return args.dtype


def resolve_device(name: str) -> torch.device:
    """The torch device ``name`` names; a CUDA device that does not exist
    raises instead of falling back to the CPU."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device={name!r} but no CUDA device is available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {name!r}")
    return dev


class ModelRunner:
    TOP_LOGPROBS_K = 8

    def __init__(
        self,
        model_config: ModelConfig,
        server_args: ServerArgs,
        mesh: Any = None,
        params: Optional[dict[str, torch.Tensor]] = None,
    ):
        """``params``: a ``state_dict`` for the model (for example from
        ``weight_loader.params_from_jax``); None loads ``model_path`` or,
        with ``random_weights``, draws seeded random weights."""
        if mesh is not None:
            raise NotImplementedError("device meshes are not ported yet")
        self.mesh = None
        self.model_config = model_config
        self.args = server_args.resolve()
        self.device = resolve_device(self.args.device)
        self.dtype = _DTYPES[self.args.dtype]
        self.page_size = self.args.page_size
        cfg = model_config

        model_cls = get_model_class(cfg.architecture)
        self.kv_cache_dtype = resolve_kv_cache_dtype(self.args, cfg, self.device)
        quant = None if self.args.quantization is None else _QUANT_ROUTE[self.args.quantization]
        # the JAX runner's quantize_lm_head auto rule: a 4-bit head whenever
        # the decoder weights are 4-bit (a bf16 head is a third of a W4
        # engine's per-step weight reads at tied-embedding models)
        self.model = model_cls(
            cfg, self.device, self.dtype, quantization=quant,
            quantize_lm_head=quant is not None,
        )
        self.attention_backend = self._set_attention(self.model)

        # ---- parameters
        t0 = time.monotonic()
        self.quantize_seconds = 0.0
        if params is not None:
            self.model.load_state_dict(params)
        elif quant is None:
            self._fill_dense(self.model)
        else:
            self._load_quantized(model_cls)
        self.model.requires_grad_(False)
        # quantized weights live in buffers
        self.param_bytes = sum(
            t.numel() * t.element_size()
            for t in itertools.chain(self.model.parameters(), self.model.buffers())
        )
        logger.info(
            "params ready: %.2f GiB in %.1fs (%.1fs quantizing)",
            self.param_bytes / 2**30,
            time.monotonic() - t0,
            self.quantize_seconds,
        )

        # ---- KV pool sizing
        self.max_context_len = server_args.context_length or cfg.context_len
        num_tokens = self._profile_kv_tokens()
        num_pages = num_tokens // self.page_size + 1  # +1 = reserved dump page
        self.kv_config = self._kv_config(num_pages)
        self.kv_cache = create_kv_cache(self.kv_config, self.device)

        # ---- allocators (page 0 reserved as the padding dump page)
        self.page_allocator = PageAllocator(num_pages, self.page_size)
        dump = self.page_allocator.alloc(1)
        assert dump is not None and dump[0] == 0
        self.max_pages_per_req = -(-self.max_context_len // self.page_size)
        self.max_running_requests = min(self.args.max_running_requests, num_pages - 1)
        self.req_slots = ReqSlotAllocator(
            self.max_running_requests, self.max_pages_per_req
        )
        self.max_total_num_tokens = (num_pages - 1) * self.page_size
        logger.info(
            "KV pool: %d pages x %d tokens, %s (%.2f GiB), max_running=%d",
            num_pages - 1,
            self.page_size,
            self.kv_cache_dtype,
            num_pages * self.page_size * self.kv_config.bytes_per_token() / 2**30,
            self.max_running_requests,
        )
        self._generator = torch.Generator(device=self.device).manual_seed(
            self.args.random_seed + 1
        )
        self.toppings_manager = None

    def _set_attention(self, model) -> str:
        """Give the model the attention functions of ``attention_backend``.
        A model that cannot take the ``pallas`` decode raises: the JAX
        runner sends it to its XLA backend, which the port keeps off the
        card."""
        backend = self.args.attention_backend
        if backend == "pallas" and not getattr(model, "supports_pallas_attention", False):
            raise NotImplementedError(
                f"{type(model).__name__} does not support attention_backend='pallas'"
            )
        model.decode_attention, model.extend_attention = attention_functions(backend)
        logger.info(
            "attention backend %s: decode %s, extend %s", backend,
            model.decode_attention.__name__, model.extend_attention.__name__,
        )
        return backend

    def attach_toppings(self, manager) -> None:
        """Serve the adapters of ``manager`` (a ``ToppingsManager`` on this
        runner's device): the model reads its device pools, which the
        manager updates in place at each registration."""
        self.toppings_manager = manager
        self.model.toppings = manager.device_pools()

    def _fill_dense(self, model) -> None:
        """An unquantized model's weights: seeded random ones (with
        ``random_weights`` or no ``model_path``) or the HF checkpoint's."""
        cfg = self.model_config
        if self.args.random_weights or not cfg.model_path:
            gen = torch.Generator(device=self.device).manual_seed(self.args.random_seed)
            model.init_random_(gen)
        else:
            state = load_hf_state(cfg.model_path)
            model.load_state_dict(model.convert_hf_state(state, self.dtype))

    def _load_quantized(self, model_cls) -> None:
        """Quantize at load, as the JAX runner does (``model_runner.py:495-610``):
        the dense weights through ``quantize_state``, or, for awq/gptq with a
        checkpoint, its int4 tensors imported bit-exact (random weights
        quantize the random init instead)."""
        cfg = self.model_config
        t = time.monotonic()
        method = self.args.quantization
        if method in ("awq", "gptq", "gptq_v2") and cfg.model_path and not self.args.random_weights:
            plain, quant = split_quant_tensors(load_hf_state(cfg.model_path))
            state = self.model.convert_hf_state(plain, self.dtype)
            layers_q = convert_quantized_layers(
                quant, cfg.num_hidden_layers, "awq" if method == "awq" else "gptq",
                gptq_v2=method == "gptq_v2",
            )
            state.update(quantized_layer_state(layers_q))
            state = self.model.quantize_state(state)  # the head, where quantized
        else:
            dense = model_cls(cfg, self.device, self.dtype)
            self._fill_dense(dense)
            state = self.model.quantize_state(dense.state_dict())
            del dense
        self.quantize_seconds = time.monotonic() - t
        self.model.load_state_dict(state)
        del state
        if self.device.type == "cuda":
            torch.cuda.empty_cache()  # the dense weights' blocks, before the pool is sized

    def _profile_kv_tokens(self) -> int:
        if self.args.max_total_tokens:
            return self.args.max_total_tokens
        if self.device.type == "cuda":
            free, total = torch.cuda.mem_get_info(self.device)
            budget = int(total * self.args.mem_fraction_static) - (total - free)
            return int(max(budget // self.kv_bytes_per_token(), 4096))
        return 2**16  # CPU default

    def _kv_config(self, num_pages: int) -> KVCacheConfig:
        cfg = self.model_config
        quant_kv = QUANT_KV_DTYPES.get(self.kv_cache_dtype)
        return KVCacheConfig(
            num_layers=cfg.num_hidden_layers,
            num_pages=num_pages,
            page_size=self.page_size,
            num_kv_heads=cfg.num_kv_heads,
            head_dim=cfg.head_dim,
            dtype=self.dtype if quant_kv else _DTYPES[self.kv_cache_dtype],
            quantized=quant_kv is not None,
            quant_dtype=quant_kv or torch.int8,
        )

    def kv_bytes_per_token(self) -> int:
        """K and V of one token over every layer, an 8-bit pool's scales
        included."""
        return self._kv_config(0).bytes_per_token()

    # ------------------------------------------------------------------ steps

    def run_extend(self, wb: WorkerBatch):
        """One extend step; returns (ids[B_real], logprobs[B_real], tops)."""
        B_real = len(wb.seq_lens)
        with torch.inference_mode():
            meta, sinfo, modes = self._pad_to_buckets(wb)
            logits = self.model(meta, self.kv_cache)
            ids, chosen, tops = self._sample(logits, sinfo, modes, wb.return_top_logprobs)
            host = self._fetch(ids[None], chosen[None])
        tops = None if tops is None else tuple(t.cpu().numpy()[:B_real] for t in tops)
        return host[0][0, :B_real], host[1][0, :B_real], tops

    def run_decode_window(self, wb: WorkerBatch, num_steps: int):
        """K fused decode steps; returns (ids[K, B_real], logprobs[K, B_real],
        tops), tops None or ([1, B, k] values, [1, B, k] ids)."""
        B_real = len(wb.seq_lens)
        if wb.return_top_logprobs and num_steps != 1:
            raise ValueError("top-logprobs needs single-step windows")
        with torch.inference_mode():
            ids, chosen, tops = self.decode_multi(wb, num_steps)
            host = self._fetch(ids, chosen)
        tops = (
            None
            if tops is None
            else tuple(t.cpu().numpy()[None, :B_real] for t in tops)
        )
        return host[0][:, :B_real], host[1][:, :B_real], tops

    def decode_multi(self, wb: WorkerBatch, num_steps: int):
        """Run a K-step decode window; ``wb`` describes the FIRST step and
        the page table must already cover ``num_steps`` more tokens per
        request. Each step's sampled ids are the next step's inputs without
        leaving the device. Returns device tensors (ids i64[K, B], chosen
        logprobs f32[K, B], tops of the last step or None)."""
        meta, sinfo, modes = self._pad_to_buckets(wb)
        ps = self.page_size
        B = meta.batch_size
        rows = torch.arange(B, device=self.device)
        ones = torch.ones(B, dtype=torch.int32, device=self.device)
        tokens, positions = meta.tokens, meta.positions
        counts = sinfo.output_token_counts
        all_ids, all_chosen, tops = [], [], None
        for _ in range(num_steps):
            loc = meta.page_table[rows, positions // ps].long() * ps + positions % ps
            step_meta = ForwardMeta(
                mode=ForwardMode.DECODE,
                tokens=tokens,
                positions=positions,
                out_cache_loc=loc,
                req_indices=rows,
                page_table=meta.page_table,
                seq_lens=(positions + 1).to(torch.int32),
                extend_lens=ones,
                last_token_idx=rows,
                active_adapters=meta.active_adapters,
                adapter_slots=meta.adapter_slots,
            )
            logits = self.model(step_meta, self.kv_cache)
            if counts is not None:
                sinfo = dataclasses.replace(sinfo, output_token_counts=counts)
            ids, chosen, tops = self._sample(
                logits, sinfo, modes, wb.return_top_logprobs
            )
            if counts is not None:
                counts = counts.index_put((rows, ids), ones, accumulate=True)
            all_ids.append(ids)
            all_chosen.append(chosen)
            tokens, positions = ids, positions + 1
        return torch.stack(all_ids), torch.stack(all_chosen), tops

    def forward_logits(self, wb: WorkerBatch) -> torch.Tensor:
        """The f32 logits [B_real, V] that one step of ``wb`` would sample
        from (its new K/V is written to the pool as in a real step)."""
        with torch.inference_mode():
            meta, _, _ = self._pad_to_buckets(wb)
            return self.model(meta, self.kv_cache)[: len(wb.seq_lens)]

    def _sample(self, logits, sinfo, modes, want_tops: bool):
        if not want_tops:
            ids, chosen = sample(
                logits, sinfo, self._generator, full_logprobs=False, modes=modes
            )
            return ids, chosen, None
        ids, logprobs = sample(logits, sinfo, self._generator, modes=modes)
        chosen = logprobs.gather(1, ids[:, None])[:, 0]
        topv, topi = torch.topk(logprobs, self.TOP_LOGPROBS_K, dim=-1)
        return ids, chosen, (topv, topi)

    @staticmethod
    def _fetch(ids: torch.Tensor, chosen: torch.Tensor):
        """ONE device-to-host copy of ids [K, B] and their logprobs [K, B]
        (the f32 logprobs ride as their int32 bit patterns)."""
        both = torch.stack([ids.to(torch.int32), chosen.float().view(torch.int32)])
        host = both.cpu().numpy()
        return host[0], host[1].view(np.float32)

    # -------------------------------------------------------------- bucketing

    def _pad_to_buckets(self, wb: WorkerBatch):
        """The batch as device tensors, the sampling state and its
        host-known modes (see ``sample``). A decode batch is padded to the
        batch-size and page-table buckets: its padding rows have
        ``seq_lens == extend_lens == 0``, write to the dump page 0 and take
        adapter slot 0, the zero adapter. An extend batch keeps its real
        size."""
        for name in _UNPORTED_BATCH_FIELDS:
            if getattr(wb, name) is not None:
                raise NotImplementedError(f"batch field {name} is not ported yet")
        adapters = wb.active_adapters is not None
        if adapters and self.toppings_manager is None:
            raise ValueError("the batch names adapters but no toppings are attached")
        B_real = len(wb.seq_lens)
        T_real = len(wb.tokens)
        P_real = max(wb.page_table.shape[1] if wb.page_table.size else 1, 1)
        if wb.mode == ForwardMode.DECODE:
            B = _next_bucket(self.args.decode_bs_buckets, B_real)
            if B_real > B:
                raise ValueError(f"{B_real} rows exceed the largest bucket {B}")
            T = B
            P = _pow2_bucket(P_real, 4, self.max_pages_per_req)
        else:
            B, T, P = B_real, T_real, P_real

        # one int64 and one int32 host buffer -> two host-to-device copies
        i64 = np.zeros(4 * T + B, np.int64)
        i64[0:T_real] = wb.tokens
        i64[T : T + T_real] = wb.positions
        i64[2 * T : 2 * T + T_real] = wb.out_cache_loc  # padding -> dump slot 0
        i64[3 * T : 4 * T] = B - 1
        i64[3 * T : 3 * T + T_real] = wb.req_indices
        csum = np.cumsum(wb.extend_lens)
        i64[4 * T : 4 * T + B_real] = np.maximum(csum - 1, 0)  # last_token_idx
        S = len(wb.active_adapters) if adapters else 0
        i32 = np.zeros(B * P + 3 * B + 1 + (S + B if adapters else 0), np.int32)
        pt = i32[: B * P].reshape(B, P)
        if wb.page_table.size:
            w = min(P_real, P)
            pt[:B_real, :w] = wb.page_table[:, :w]
        o = B * P
        i32[o : o + B_real] = wb.seq_lens
        i32[o + B : o + B + B_real] = wb.extend_lens
        i32[o + 2 * B + 1 : o + 2 * B + 1 + B_real] = csum  # cu_q_lens[1:]
        i32[o + 2 * B + 1 + B_real : o + 3 * B + 1] = csum[-1] if B_real else 0
        a = o + 3 * B + 1
        if adapters:
            i32[a : a + S] = wb.active_adapters
            i32[a + S : a + S + B_real] = wb.adapter_slots  # padding rows: slot 0
        d64 = torch.from_numpy(i64).to(self.device)
        d32 = torch.from_numpy(i32).to(self.device)
        meta = ForwardMeta(
            mode=wb.mode,
            tokens=d64[0:T],
            positions=d64[T : 2 * T],
            out_cache_loc=d64[2 * T : 3 * T],
            req_indices=d64[3 * T : 4 * T],
            page_table=d32[: B * P].view(B, P),
            seq_lens=d32[o : o + B],
            extend_lens=d32[o + B : o + 2 * B],
            last_token_idx=d64[4 * T : 4 * T + B],
            cu_q_lens=d32[o + 2 * B : o + 3 * B + 1],
            active_adapters=d32[a : a + S] if adapters else None,
            adapter_slots=d32[a + S : a + S + B] if adapters else None,
        )

        si = wb.sampling_info
        V = self.model_config.vocab_size

        def padB(x, fill):
            if x is None:
                return None
            out = np.full((B,) + x.shape[1:], fill, x.dtype)
            out[: x.shape[0]] = x
            return out

        sinfo_host = SamplingBatchInfo(
            temperature=padB(si.temperature, 0.0),
            top_p=padB(si.top_p, 1.0),
            top_k=padB(si.top_k, V),
            min_p=padB(si.min_p, 0.0),
            presence_penalty=padB(si.presence_penalty, 0.0),
            frequency_penalty=padB(si.frequency_penalty, 0.0),
            repetition_penalty=padB(si.repetition_penalty, 1.0),
            output_token_counts=padB(si.output_token_counts, 0),
            input_token_mask=padB(si.input_token_mask, False),
            logit_bias=padB(si.logit_bias, 0.0),
        )
        return meta, sinfo_host.to(self.device), sinfo_host.modes(V)
