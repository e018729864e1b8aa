"""ModelRunner: owns the model, the paged KV pool, the allocators and the step.

Counterpart of ``scratchpad_tpu/executor/model_runner.py``, for the part the
port has: parameter and KV-pool sizing, ``run_extend``, the fused decode
window (``run_decode_window`` / ``decode_multi``) and its pipelined halves
(``dispatch_decode_window`` / ``fetch_decode_window``), embeddings
(``run_embed``), teacher-forced scoring (``run_score``), speculative
verification (``run_spec_verify``, ``_h``, ``_sampled``,
``run_extend_with_hidden``, ``run_kv_only``) and the memory extras (pages
to and from the host KV tier, ``resize_kv_pool``, ``update_weights``,
parameter offload through ``executor/param_offload.py``). PyTorch runs
eagerly: a step is the model's forward followed by ``sample``, and a decode
window is a loop of K steps whose sampled ids stay on the device and feed
the next step, with one host fetch per window. Host inputs go up from pinned
buffers without a host sync, so a window can be dispatched while the
previous one still runs on the card. Decode batches are padded to the
batch-size buckets that CUDA graphs will be captured at (later work), so
their padding rows reach the decode kernel as they will then; an extend
batch runs at its real size, since nothing is compiled for its shape. Every
forward runs at least ``MIN_ROWS`` rows.

Attention runs through the kernel wrappers that ``attention_backend``
names (``auto`` or ``pallas``), which launch the hand-written CUDA kernels
for CUDA tensors and take their plain PyTorch versions for CPU tensors. A
model with multi-head latent attention (DeepSeek, ``cfg.is_mla``) gets a
latent pool instead (one ``[c_kv | k_rope]`` row a token and layer, in the
model dtype; 8-bit refused) and attends through
``ops/attention/mla_backend.py`` alone. ``attach_toppings`` hands a
``ToppingsManager``'s device pools to the model; a batch that names
adapters then carries its slot table in the same upload buffer as the rest
of its integers. A batch with a custom logit processor carries the
processors, their row masks (padded to the batch bucket) and their params
to the sampler, and never runs as a pipelined window. For the vision
models, ``encode_images`` and ``encode_videos`` run the tower and projector
when a request is made, ``VISION_BATCH`` images at a time, and a batch's
multimodal fields (vision rows, 3-D rope positions, rope shifts, image
spans) go up beside its integers; such a batch never runs as a pipelined
window either. ``quantization="fp8"`` quantizes the dense init on its device
(``ops/quant/fp8.py``), and the KV pool's sizing leaves the forwards'
workspace free (``forward_workspace_bytes``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import sys
import time
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from scratchpad_tpu_torch.config import ModelConfig, ServerArgs
from scratchpad_tpu_torch.executor.forward_meta import ForwardMeta, ForwardMode
from scratchpad_tpu_torch.executor.weight_loader import (
    load_hf_state,
    quantized_layer_state,
    shard_state,
    w4_real_widths,
)
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
from scratchpad_tpu_torch.parallel import check_tp_model
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
    """Host-side batch handed from the scheduler. The multimodal fields:
    vision features of the placeholder rows [T_real, H] f32, Qwen2-VL's 3-D
    positions [3, T_real] or its per-request shift [B_real], Gemma 3's
    bidirectional spans [B_real, M, 2]; Mllama's cross-attention slots
    (0: no image), live cross rows and image placeholder positions
    [B_real]."""

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
    cross_slots: Optional[np.ndarray] = None
    cross_lens: Optional[np.ndarray] = None
    cross_starts: Optional[np.ndarray] = None


class PendingWindow(NamedTuple):
    """A dispatched decode window: ``host`` receives ids and logprob bits
    [2, K, B] once ``done`` (a CUDA event; None on the CPU) has fired;
    ``last_ids`` [B] stay on the device to chain the next window."""

    host: torch.Tensor
    last_ids: torch.Tensor
    rows: int
    done: Optional[torch.cuda.Event]


# the fewest rows (requests, and tokens) a forward runs at: a matmul of one
# row takes torch's vector path (gemv on the CPU), whose sums are ordered
# otherwise than the matrix path's, so a request's logits would depend on
# whether it was batched alone. From two rows on, each row's result is the
# same at every row count.
MIN_ROWS = 2


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


# quantization -> the model's route: w4a8, w4a16 for every other W4 name,
# or fp8
_QUANT_ROUTE = {
    "w4a8": "w4a8", "w4a16": "w4a16", "w4": "w4a16",
    "awq": "w4a16", "gptq": "w4a16", "gptq_v2": "w4a16", "fp8": "fp8",
}


def resolve_kv_cache_dtype(args: ServerArgs, cfg: ModelConfig, device: torch.device) -> str:
    """The KV pool's dtype: ``int8`` or ``fp8`` (8-bit codes with per-(token,
    head) bf16 scales), or the model dtype. ``auto`` follows the JAX
    runner's model-aware rule (``model_runner.py:207-222``): int8 KV for
    W4-quantized serving on an accelerator through the ``auto`` backend (the
    JAX runner's ``gqa``, which a model class without
    ``supports_pallas_attention`` never gets: ``:198``) when hidden x layers
    >= 50,000 (3B and up) on a single device (the JAX ``mesh is None``:
    ``tp_size`` 1); otherwise, as an explicit ``bfloat16`` does, the pool
    takes the model dtype. Unlike the JAX runner it leaves ``args`` as it
    is."""
    if args.kv_cache_dtype in QUANT_KV_DTYPES:
        return args.kv_cache_dtype
    if (
        args.kv_cache_dtype == "auto"
        and args.attention_backend == "auto"
        and getattr(get_model_class(cfg.architecture), "supports_pallas_attention", False)
        and args.quantization in ("w4a8", "w4a16", "awq", "gptq")
        and device.type == "cuda"
        and args.tp_size == 1
        and cfg.hidden_size * cfg.num_hidden_layers >= 50_000
    ):
        logger.info(
            "kv_cache_dtype auto -> int8 (quantized serving, hidden x layers = %d; "
            "set kv_cache_dtype='bfloat16' to force full-precision KV)",
            cfg.hidden_size * cfg.num_hidden_layers,
        )
        return "int8"
    return args.dtype


def kv_budget_bytes(free: int, total: int, mem_fraction: float, workspace: int) -> int:
    """Bytes the KV pool may take: ``mem_fraction`` of the card less what
    is already held, less the ``workspace`` that forwards allocate beside
    the pool (MLA's decode gather, a vision tower's activations)."""
    return int(total * mem_fraction) - (total - free) - workspace


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
        companion: tuple[int, int] = (0, 0),
    ):
        """``params``: a ``state_dict`` for the model (for example from
        ``weight_loader.params_from_jax``); None loads ``model_path`` or,
        with ``random_weights``, draws seeded random weights. ``companion``:
        (parameter bytes, KV bytes a token) of a draft model or EAGLE head
        that will share the card and this pool's token count; the pool is
        sized so that both fit. ``mesh``: a tensor-parallel rank's group
        (``parallel.TPGroup``; the JAX runner's mesh), or None. The rank
        then runs on the group's device, holds its shard of the weights
        (``params`` is the single-device state, cut by ``shard_state``) and
        a pool of its Hkv / tp heads, whose page count is the minimum over
        the ranks, since the leader's page tables index every rank's pool."""
        self.mesh = mesh
        self.model_config = model_config
        self.args = server_args.resolve()
        self.device = resolve_device(self.args.device) if mesh is None else mesh.device
        self.dtype = _DTYPES[self.args.dtype]
        self.page_size = self.args.page_size
        cfg = model_config

        model_cls = get_model_class(cfg.architecture)
        if mesh is not None:
            check_tp_model(cfg, mesh.size, self.args.quantization)
        self.kv_cache_dtype = resolve_kv_cache_dtype(self.args, cfg, self.device)
        if cfg.is_mla and self.kv_cache_dtype in QUANT_KV_DTYPES:
            raise NotImplementedError(
                f"kv_cache_dtype={self.kv_cache_dtype!r} for {cfg.architecture}: an 8-bit latent "
                "(MLA) pool is not supported, as in the JAX package; use 'auto' (the model dtype)"
            )
        if getattr(model_cls, "has_cross_attention", False) and self.kv_cache_dtype in QUANT_KV_DTYPES:
            raise NotImplementedError(
                f"kv_cache_dtype={self.kv_cache_dtype!r} for {cfg.architecture}: 8-bit KV for a "
                "cross-attention model has no parity test against the JAX engine yet (ROADMAP.md); "
                "use 'auto' (the model dtype)"
            )
        quant = None if self.args.quantization is None else _QUANT_ROUTE[self.args.quantization]
        qlm = self.quantize_lm_head = self._quantize_lm_head(model_cls, quant)
        # the allocator's peak above what the process held before the model
        # (another engine of the process, say) is the load's
        held = 0
        if self.device.type == "cuda":
            held = torch.cuda.memory_allocated(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        self.model = model_cls(
            cfg, self.device, self.dtype, quantization=quant, quantize_lm_head=qlm,
            **({} if mesh is None else {"tp": mesh}),
        )
        self.attention_backend = self._set_attention(self.model)

        # ---- parameters
        t0 = time.monotonic()
        self.quantize_seconds = 0.0
        if params is not None:
            self.model.load_state_dict(self._shard(params))
        elif quant is None and not qlm:
            self._fill_dense(self.model)
        elif mesh is not None:
            self._load_quantized_tp(model_cls)
        else:
            self._load_quantized(model_cls)
        # the allocator's peak while the model was built and its weights
        # loaded (a rank's, in its own process); None on the CPU
        self.load_peak_bytes = (
            torch.cuda.max_memory_allocated(self.device) - held if self.device.type == "cuda" else None
        )
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

        self.param_offload = None
        if self.args.enable_param_offload:
            from scratchpad_tpu_torch.executor.param_offload import ParamOffload

            self.param_offload = ParamOffload(self.model, self.args.param_offload_groups)

        # ---- KV pool sizing, after every rank has loaded its weights; a
        # rank's pool takes the fewest tokens of any rank's
        self.max_context_len = server_args.context_length or cfg.context_len
        self.companion = companion
        if mesh is not None:
            mesh.barrier("loaded")
        num_tokens = self._profile_kv_tokens()
        if mesh is not None:
            num_tokens = mesh.min_int(num_tokens)
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
        # every tensor-parallel rank draws from a generator seeded alike, so
        # that a sampled window is the same on every rank
        self._generator = torch.Generator(device=self.device).manual_seed(
            self.args.random_seed + 1
        )
        self.toppings_manager = None
        # forwards run by mode, and (tensor parallel) digests of every token
        # and logprob this rank sampled and of every forward_logits result,
        # for tp_report
        self.forward_counts = dict.fromkeys(ForwardMode, 0)
        self._token_digest = hashlib.blake2b(digest_size=16)
        self._logits_digest = hashlib.blake2b(digest_size=16)
        self._tokens_sampled = 0

    def _set_attention(self, model) -> str:
        """Give the model the attention functions of ``attention_backend``.
        A model that cannot take the ``pallas`` decode raises: the JAX
        runner sends it to its XLA backend, which the port keeps off the
        card."""
        backend = self.args.attention_backend
        mla = model.cfg.is_mla
        if backend == "pallas" and not getattr(model, "supports_pallas_attention", False):
            raise NotImplementedError(
                f"{type(model).__name__} does not support attention_backend='pallas'"
                + (" (multi-head latent attention runs over its latent pool only)" if mla else "")
            )
        if mla:  # never the decode and extend kernels
            logger.info("attention backend %s: multi-head latent attention (mla_backend)", backend)
            return backend
        cfg = model.cfg  # a tensor-parallel rank's model holds its group
        model.decode_attention, model.extend_attention = attention_functions(
            backend, getattr(model, "tp", None), (cfg.num_attention_heads, cfg.num_kv_heads)
        )
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
            model.load_state_dict(self._shard(model.convert_hf_state(state, self.dtype)))

    def _quantize_lm_head(self, model_cls, quant) -> bool:
        """The JAX runner's ``quantize_lm_head`` (``model_runner.py:579-610``):
        ``None`` is its auto rule, a 4-bit head whenever the decoder weights
        are 4-bit (a bf16 head is a third of a W4 engine's per-step weight
        reads at tied-embedding models), for the classes whose logits read
        it, never beside an EAGLE head (it shares the target's bf16 head);
        fp8 leaves the head. A mesh never quantizes it: under tp_size > 1 the
        head stays the vocabulary-parallel bf16 one, and a set flag is
        ignored with a warning, as the JAX runner ignores it."""
        qlm = self.args.quantize_lm_head
        if qlm is None:
            qlm = (
                quant in ("w4a8", "w4a16")
                and getattr(model_cls, "supports_quantized_lm_head", True)
                and self.args.speculative_algorithm != "eagle"
            )
        if qlm and self.mesh is not None:
            if self.args.quantize_lm_head:
                logger.warning(
                    "quantize_lm_head=True under tp_size=%d is ignored: the head stays the "
                    "vocabulary-parallel %s one, as the JAX runner keeps it on a mesh",
                    self.mesh.size, self.args.dtype,
                )
            qlm = False
        return bool(qlm)

    def _shard(self, state: dict) -> dict:
        """A single-device ``state_dict`` as this rank's shards (as it is at
        tp 1); a padded W4 stored width is cut at its real columns."""
        if self.mesh is None:
            return state
        size, family = self.mesh.size, self.model.tp_family
        return shard_state(state, self.mesh.rank, size, family, w4_real_widths(self.model, size))

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

    @torch.no_grad()
    def _load_quantized_tp(self, model_cls) -> None:
        """A tensor-parallel rank's quantized weights, one whole tensor at a
        time: each tensor of the unquantized twin drawn (a twin on the meta
        device draws the tp 1 stream: ``init_random_(place=...)``) or
        converted from the checkpoint, quantized whole on the device and cut
        to the rank's part (the model's ``place_whole``), then freed. A
        rank's peak is its shards and one whole tensor (gate|up: two)
        beside them. An awq or gptq checkpoint's int4 tensors come
        quantized: the converted state is cut as ``params`` are."""
        cfg = self.model_config
        t = time.monotonic()
        method = self.args.quantization
        pending: dict = {}

        def place(name, whole, expert=None):
            self.model.place_whole(name, whole, pending, expert)

        twin = model_cls(cfg, torch.device("meta"), self.dtype)
        self.model.reset_constants_()
        if method in ("awq", "gptq", "gptq_v2") and cfg.model_path and not self.args.random_weights:
            plain, quant = split_quant_tensors(load_hf_state(cfg.model_path))
            state = twin.convert_hf_state(plain, self.dtype)
            state.update(quantized_layer_state(convert_quantized_layers(
                quant, cfg.num_hidden_layers, "awq" if method == "awq" else "gptq",
                gptq_v2=method == "gptq_v2",
            )))
            self.model.load_state_dict(self._shard(state))
        elif self.args.random_weights or not cfg.model_path:
            twin.init_random_(torch.Generator(device=self.device).manual_seed(self.args.random_seed), place=place)
        else:
            for name, w in twin.convert_hf_state(load_hf_state(cfg.model_path), self.dtype).items():
                place(name, w)
        if pending:
            raise ValueError(f"gate without up (or up without gate) at load: {sorted(pending)}")
        self.quantize_seconds = time.monotonic() - t
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # images (or video temporal patches) the vision tower encodes at once
    VISION_BATCH = 4

    def forward_workspace_bytes(self) -> int:
        """What the pool's sizing must leave free beside the pool and the
        weights: what a forward allocates (MLA's decode gather bound,
        ``mla_backend.DECODE_GATHER_BYTES``; the vision tower's peak for the
        images it encodes at once; a cross layer's scores,
        ``mllama.cross_workspace_bytes``) and a cross-attention model's slot
        buffer, allocated beside the pool."""
        from scratchpad_tpu_torch.ops.attention.mla_backend import DECODE_GATHER_BYTES

        ws = DECODE_GATHER_BYTES if self.model_config.is_mla else 0
        vision = getattr(self.model, "vision", None)
        if vision is not None:
            ws += vision.workspace_bytes(self._vision_batch)
        if getattr(self.model, "has_cross_attention", False):
            from scratchpad_tpu_torch.models.mllama import cross_workspace_bytes

            ws += self._kv_config(0).cross_bytes() + cross_workspace_bytes(self.model.cfg, self.model.cross_len)
        return ws

    @property
    def _vision_batch(self) -> int:
        """Images (or video temporal patches) the tower encodes at once."""
        return getattr(self.model.vision, "encode_batch", self.VISION_BATCH)

    def _profile_kv_tokens(self) -> int:
        if self.args.max_total_tokens:
            return self.args.max_total_tokens
        if self.device.type == "cuda":
            free, total = torch.cuda.mem_get_info(self.device)
            companion_params, companion_bpt = self.companion
            budget = kv_budget_bytes(
                free, total, self.args.mem_fraction_static, self.forward_workspace_bytes()
            ) - companion_params
            if self.mesh is not None:  # the ranks on this card share its budget
                budget //= self.mesh.ranks_on_device
            tokens = int(max(budget // (self.kv_bytes_per_token() + companion_bpt), 4096))
            if companion_params:
                logger.info(
                    "KV split: %d tokens, %d B a token here and %d B a token beside it, "
                    "after %.2f GiB of the companion's parameters",
                    tokens, self.kv_bytes_per_token(), companion_bpt, companion_params / 2**30,
                )
            return tokens
        return 2**16  # CPU default

    def _kv_config(self, num_pages: int) -> KVCacheConfig:
        cfg = self.model_config
        if cfg.is_mla:  # one [c_kv | k_rope] row a token and layer (JAX :707-712)
            return KVCacheConfig(
                num_layers=cfg.num_hidden_layers, num_pages=num_pages, page_size=self.page_size,
                num_kv_heads=1, head_dim=self.model.mla_latent_dim,
                dtype=_DTYPES[self.kv_cache_dtype], mla=True,
            )
        quant_kv = QUANT_KV_DTYPES.get(self.kv_cache_dtype)
        # a cross-attention model pages its self layers only, and keeps its
        # images' K/V in slots beside the pool (JAX :713-744)
        cross = {}
        if getattr(self.model, "has_cross_attention", False):
            cross = dict(cross_layers=len(self.model.cross_idx), cross_len=self.model.cross_len,
                         cross_slots=self.args.cross_kv_slots + 1)
        return KVCacheConfig(
            num_layers=getattr(self.model, "num_kv_layers", cfg.num_hidden_layers),
            num_pages=num_pages,
            page_size=self.page_size,
            num_kv_heads=cfg.num_kv_heads // (1 if self.mesh is None else self.mesh.size),
            head_dim=cfg.head_dim,
            dtype=self.dtype if quant_kv else _DTYPES[self.kv_cache_dtype],
            quantized=quant_kv is not None,
            quant_dtype=quant_kv or torch.int8,
            **cross,
        )

    def kv_bytes_per_token(self) -> int:
        """K and V of one token over every layer, an 8-bit pool's scales
        included; a latent pool's one row a layer."""
        return self._kv_config(0).bytes_per_token()

    # ------------------------------------------------------------------ steps

    def run_extend(self, wb: WorkerBatch):
        """One extend step; returns (ids[B_real], logprobs[B_real], tops)."""
        B_real = len(wb.seq_lens)
        with torch.inference_mode():
            meta, sinfo, modes = self._pad_to_buckets(wb)
            logits = self._forward(meta)
            ids, chosen, tops = self._sample(logits, sinfo, modes, wb.return_top_logprobs)
            host = self._fetch(ids[None], chosen[None])
        tops = None if tops is None else tuple(t.cpu().numpy()[:B_real] for t in tops)
        return host[0][0, :B_real], host[1][0, :B_real], tops

    def run_decode_window(self, wb: WorkerBatch, num_steps: int):
        """K fused decode steps; returns (ids[K, B_real], logprobs[K, B_real],
        tops), tops None or ([1, B, k] values, [1, B, k] ids). A batch that
        the pipelined path takes is dispatched and fetched at once."""
        if self._packed_supported(wb):
            return self.fetch_decode_window(self.dispatch_decode_window(wb, num_steps))
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

    def _packed_supported(self, wb: WorkerBatch) -> bool:
        """Whether ``wb`` may run as a pipelined window: no penalty counts,
        logit bias, custom logit processor, grammar mask or top-logprobs
        (they need the host between windows), and adapters only once a
        manager is attached (the JAX rule, ``model_runner.py:1067-1081``,
        for the fields the port has)."""
        si = wb.sampling_info
        return (
            wb.vocab_bitmask is None
            and si.output_token_counts is None
            and si.logit_bias is None
            and si.custom_processors is None
            and (wb.active_adapters is None or self.toppings_manager is not None)
            and wb.input_embeds is None
            and wb.mm_spans is None
            and wb.mrope_positions is None
            and wb.rope_delta is None
            and wb.cross_slots is None
            and not wb.return_top_logprobs
        )

    def dispatch_decode_window(
        self, wb: WorkerBatch, num_steps: int, prev_tokens: Optional[torch.Tensor] = None
    ) -> PendingWindow:
        """Launch a K-step decode window and one non-blocking copy of its ids
        and logprobs to a pinned host buffer, with no host sync; returns the
        handle ``fetch_decode_window`` waits on. ``prev_tokens``: the previous
        window's last ids [B bucket], still on the device, as this window's
        first inputs (``wb.tokens`` is then ignored)."""
        with torch.inference_mode():
            ids, chosen, _ = self.decode_multi(wb, num_steps, first_tokens=prev_tokens)
            both = torch.stack([ids.to(torch.int32), chosen.float().view(torch.int32)])
            done = None
            if self.device.type == "cuda":
                host = torch.empty(both.shape, dtype=torch.int32, pin_memory=True)
                host.copy_(both, non_blocking=True)
                done = torch.cuda.Event()
                done.record()
            else:
                host = both
        return PendingWindow(host, ids[-1], len(wb.seq_lens), done)

    def fetch_decode_window(self, pending: PendingWindow):
        """Wait for a dispatched window; returns what ``run_decode_window``
        returns (tops None)."""
        if pending.done is not None:
            pending.done.synchronize()
        host = pending.host.numpy()
        self._record(host)
        B_real = pending.rows
        return host[0][:, :B_real], host[1].view(np.float32)[:, :B_real], None

    def decode_multi(
        self, wb: WorkerBatch, num_steps: int, first_tokens: Optional[torch.Tensor] = None
    ):
        """Run a K-step decode window; ``wb`` describes the FIRST step and
        the page table must already cover ``num_steps`` more tokens per
        request. Each step's sampled ids are the next step's inputs without
        leaving the device; ``first_tokens`` [B bucket], on the device,
        replaces the first step's inputs. Returns device tensors (ids
        i64[K, B], chosen logprobs f32[K, B], tops of the last step or
        None)."""
        meta, sinfo, modes = self._pad_to_buckets(wb)
        ps = self.page_size
        B = meta.batch_size
        rows = torch.arange(B, device=self.device)
        ones = torch.ones(B, dtype=torch.int32, device=self.device)
        tokens, positions = meta.tokens, meta.positions
        if first_tokens is not None:
            if first_tokens.shape != tokens.shape:
                raise ValueError(
                    f"prev_tokens {tuple(first_tokens.shape)} do not match the window's "
                    f"{tuple(tokens.shape)} rows"
                )
            tokens = first_tokens
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
                rope_delta=meta.rope_delta,
                # every step masks the padding tiles as the first did
                cross_requests=meta.cross_requests,
            )
            logits = self._forward(step_meta)
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

    # ----------------------------------------------------------------- vision

    def encode_images(self, pixel_values: np.ndarray, ar_ids=None, n_tiles=None) -> np.ndarray:
        """The model's vision tower and projector: [N, C, S, S] pixels ->
        f32 [N, tokens, H], or a tiled model's tiles [N, T, C, S, S] with
        their aspect-ratio ids and live tile counts [N] -> f32 [N, T x
        patches, H] (JAX :1086-1110); the tower's ``encode_batch`` images at
        a time (``VISION_BATCH`` where it sets none)."""
        if not hasattr(self.model, "encode_images"):
            raise ValueError(f"{self.model_config.architecture} is not a multimodal model")
        tiled = () if ar_ids is None else tuple(
            torch.as_tensor(np.asarray(a, np.int64), device=self.device) for a in (ar_ids, n_tiles)
        )
        return self._encode(self.model.encode_images, pixel_values, self._vision_batch, *tiled)

    def image_token_embedding(self) -> np.ndarray:
        """The learned ``<|image|>`` embedding row, f32 [H] (Mllama's
        placeholder; JAX :1127-1130)."""
        return self.model.embed.weight[self.model.image_token_index].float().cpu().numpy()

    def encode_videos(self, frames: np.ndarray) -> np.ndarray:
        """A video's frames [T, C, S, S] -> f32 [grid_t, tokens, H] (real
        temporal patches, ``models/qwen2_vl.py::encode_video``),
        ``VISION_BATCH`` temporal patches at a time."""
        if not getattr(self.model, "supports_video", False):
            raise ValueError(f"{self.model_config.architecture} does not support video")
        return self._encode(self.model.encode_video, frames, self._vision_batch * self.model.vision.tpatch)

    def _encode(self, fn, pixels: np.ndarray, step: int, *rows: torch.Tensor) -> np.ndarray:
        """``fn`` over ``pixels``, and the tensors ``rows`` row for row,
        ``step`` rows at a time."""
        with torch.inference_mode():
            px = torch.from_numpy(np.ascontiguousarray(pixels, np.float32))
            out = [
                fn(px[i : i + step].to(self.device, self.dtype), *(r[i : i + step] for r in rows)).float().cpu()
                for i in range(0, px.shape[0], step)
            ]
        return torch.cat(out).numpy()

    def run_embed(self, wb: WorkerBatch) -> np.ndarray:
        """An extend pass that returns each row's L2-normalised last-token
        hidden state (after the final norm), f32 [B_real, H]."""
        with torch.inference_mode():
            meta, _, _ = self._pad_to_buckets(wb)
            meta.capture_hidden = True
            emb = self._forward(meta).float()
            emb = emb / emb.norm(dim=-1, keepdim=True).clamp_min(1e-9)
            return emb.cpu().numpy()[: len(wb.seq_lens)]

    SCORE_CHUNK = 128  # rows of the [T, V] logits built at a time

    def run_score(self, wb: WorkerBatch) -> np.ndarray:
        """Teacher-forced next-token logprobs of one extend batch: entry t is
        log p(tokens[t + 1] | tokens[..t]) (the last entry has no target);
        returns f32 [T_real]. The head runs ``SCORE_CHUNK`` rows at a time,
        so the [T, V] logits are never built whole."""
        T_real = len(wb.tokens)
        with torch.inference_mode():
            meta, _, _ = self._pad_to_buckets(wb)
            meta.capture_all_hidden = True
            h = self._forward(meta)  # [T, H]
            targets = torch.cat([meta.tokens[1:], meta.tokens.new_zeros(1)])
            out = []
            for c in range(0, h.shape[0], self.SCORE_CHUNK):
                logits = self.model.head_logits(h[c : c + self.SCORE_CHUNK])
                tc = targets[c : c + self.SCORE_CHUNK, None]
                out.append(logits.gather(1, tc)[:, 0] - torch.logsumexp(logits, dim=-1))
            return torch.cat(out).cpu().numpy()[:T_real]

    def _forward(self, meta: ForwardMeta) -> torch.Tensor:
        """The model's forward over the pool: its layers streamed from the
        host a group at a time under parameter offload."""
        self.forward_counts[meta.mode] += 1
        if self.param_offload is not None:
            return self.param_offload.forward(meta, self.kv_cache)
        return self.model(meta, self.kv_cache)

    # ------------------------------------------------ speculative decoding

    def _hidden(self, wb: WorkerBatch):
        """An extend forward of ``wb`` that keeps every row's final-normed
        hidden state: (meta, sampling state, modes, h [T, H])."""
        meta, sinfo, modes = self._pad_to_buckets(wb)
        meta.capture_all_hidden = True
        return meta, sinfo, modes, self._forward(meta)

    def _head_rows(self, h: torch.Tensor, pick):
        """``pick(logits, c)`` over the head's logits ``SCORE_CHUNK`` rows
        at a time (c: the chunk's first row), so the [T, V] logits are
        never built whole; its (ids, logprobs) chunks joined."""
        ids, lps = [], []
        for c in range(0, h.shape[0], self.SCORE_CHUNK):
            i, lp = pick(self.model.head_logits(h[c : c + self.SCORE_CHUNK]), c)
            ids.append(i)
            lps.append(lp)
        return torch.cat(ids), torch.cat(lps)

    def _spec_out(self, wb: WorkerBatch, ids, lps, h, return_hidden: bool):
        host = self._fetch(ids[None], lps[None])
        T_real = len(wb.tokens)
        out = (host[0][0, :T_real], host[1][0, :T_real])
        if return_hidden:
            out += (h[:T_real].float().cpu().numpy(),)
        return out

    def run_spec_verify(self, wb: WorkerBatch, return_hidden: bool = False):
        """Greedy speculative verification: one extend forward over
        ``[last_token, draft_1..draft_k]`` rows a request; returns the
        greedy token and its logprob at EVERY row (ids [T_real], logprobs
        [T_real]), and with ``return_hidden`` the rows' features (final-normed
        hidden states, f32 [T_real, H]) for EAGLE. Rejected rows' K/V stay
        past the request's length and are overwritten later."""
        with torch.inference_mode():
            _, _, _, h = self._hidden(wb)

            def greedy(logits, c):
                i = logits.argmax(dim=-1)
                return i, logits.gather(1, i[:, None])[:, 0] - torch.logsumexp(logits, dim=-1)

            ids, lps = self._head_rows(h, greedy)
            return self._spec_out(wb, ids, lps, h, return_hidden)

    def run_spec_verify_h(self, wb: WorkerBatch):
        """``run_spec_verify`` with the rows' features (EAGLE)."""
        return self.run_spec_verify(wb, return_hidden=True)

    def run_spec_verify_sampled(self, wb: WorkerBatch, return_hidden: bool = False):
        """Sampled speculative verification: the target continuation
        SAMPLED at every row with its request's temperature, top-k, top-p
        and min-p (the rows gathered by ``req_indices``; the head's logits
        soft-capped as served). The proposals are deterministic (a point
        mass q), so the accept rule min(1, p/q) with its residual resample
        reduces to: sample t_j ~ p_j at every row, accept while t_j equals
        the draft, and emit the first mismatching t_j; the emitted token is
        p_j-distributed either way (JAX ``model_runner.py:1715-1727``). Each
        chunk draws from the runner's generator in turn, so no stream repeats
        across chunks or steps."""
        with torch.inference_mode():
            meta, sinfo, modes, h = self._hidden(wb)
            ri = meta.req_indices

            def sampled(logits, c):
                rows = ri[c : c + logits.shape[0]]
                info = SamplingBatchInfo(
                    temperature=sinfo.temperature[rows], top_p=sinfo.top_p[rows],
                    top_k=sinfo.top_k[rows], min_p=sinfo.min_p[rows],
                )
                return sample(logits, info, self._generator, full_logprobs=False, modes=modes)

            ids, lps = self._head_rows(h, sampled)
            return self._spec_out(wb, ids, lps, h, return_hidden)

    def run_extend_with_hidden(self, wb: WorkerBatch):
        """An extend step that also returns every row's feature: (ids
        [B_real], logprobs [B_real], features f32 [T_real, H]), the EAGLE
        prefill."""
        if wb.return_top_logprobs:
            raise ValueError("run_extend_with_hidden takes no top-logprobs")
        B_real = len(wb.seq_lens)
        with torch.inference_mode():
            meta, sinfo, modes, h = self._hidden(wb)
            logits = self.model.head_logits(h[meta.last_token_idx])
            ids, chosen, _ = self._sample(logits, sinfo, modes, False)
            host = self._fetch(ids[None], chosen[None])
            feats = h[: len(wb.tokens)].float().cpu().numpy()
        return host[0][0, :B_real], host[1][0, :B_real], feats

    def run_kv_only(self, wb: WorkerBatch) -> None:
        """An extend forward that only writes the batch's K/V (a draft
        model's pool kept in step with the target's accepted tokens); the
        head does not run."""
        with torch.inference_mode():
            meta, _, _ = self._pad_to_buckets(wb)
            meta.capture_hidden = True
            self._forward(meta)

    # --------------------------------------------------- memory extras

    def gather_pages(self, page_ids: np.ndarray) -> list[torch.Tensor]:
        """Logical pages of every layer as copies on the device, one tensor
        ``[n, L, ps, ...]`` for each of the pool's K, V and, in an 8-bit
        pool, K and V scales (a latent pool: its one tensor). Enqueued on
        the current stream, so it reads the pages as every earlier step left
        them; the host KV tier copies them out."""
        idx = torch.as_tensor(np.asarray(page_ids, np.int64), device=self.device)
        return [t.index_select(1, idx).transpose(0, 1).contiguous() for t in self._pool_tensors()]

    def scatter_pages(self, page_ids: np.ndarray, pages: list[torch.Tensor]) -> None:
        """Write ``pages`` (as ``gather_pages`` gives them, on any device)
        into the pool at ``page_ids``."""
        idx = torch.as_tensor(np.asarray(page_ids, np.int64), device=self.device)
        with torch.inference_mode():
            for t, p in zip(self._pool_tensors(), pages):
                p = p.to(self.device, non_blocking=True).transpose(0, 1)
                if t.element_size() == 1:  # fp8 codes as bytes (no CPU index_copy_ for fp8)
                    t, p = t.view(torch.uint8), p.view(torch.uint8)
                t.index_copy_(1, idx, p)

    def _pool_tensors(self) -> list[torch.Tensor]:
        kv = self.kv_cache
        return [t for t in (kv.k, kv.v, kv.k_scale, kv.v_scale) if t is not None]

    def resize_kv_pool(self, new_num_tokens: int) -> int:
        """Reallocate the pool for ``new_num_tokens`` tokens (the old one is
        released first); the caller must have flushed every cached page, as
        page ids start again. Returns the new token capacity."""
        ps = self.page_size
        new_pages = new_num_tokens // ps + 1
        if new_pages < 2:
            raise ValueError("KV pool must hold at least one page")
        self.kv_cache = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        self.kv_config = dataclasses.replace(self.kv_config, num_pages=new_pages)
        self.kv_cache = create_kv_cache(self.kv_config, self.device)
        self.page_allocator = PageAllocator(new_pages, ps)
        dump = self.page_allocator.alloc(1)
        assert dump is not None and dump[0] == 0
        self.max_running_requests = min(self.args.max_running_requests, new_pages - 1)
        self.max_total_num_tokens = (new_pages - 1) * ps
        logger.info(
            "KV pool resized: %d pages x %d tokens (%.2f GiB)", new_pages - 1, ps,
            new_pages * ps * self.kv_config.bytes_per_token() / 2**30,
        )
        return self.max_total_num_tokens

    def update_weights(self, state: dict) -> tuple[bool, str]:
        """Swap in new weights: ``state`` is an HF-named state dict, or the
        unquantized model's own ``state_dict`` names (``layers.0.wq.weight``).
        A W4 or fp8 engine quantizes it again on its device. Every name and
        shape is checked before a weight is copied, so a bad state leaves
        the old weights in place. The caller flushes the radix cache, whose
        K/V belong to the old weights."""
        try:
            with torch.inference_mode():
                hf = any(k.startswith("model.") for k in state)
                dense = self.model.convert_hf_state(state, self.dtype) if hf else {
                    k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v).to(self.dtype)
                    for k, v in state.items()
                }
                if self.args.quantization is not None:
                    dense = self.model.quantize_state(dense)
                owner = self.param_offload or self.model
                target = owner.state_dict()
                missing = sorted(set(target) - set(dense))
                extra = sorted(set(dense) - set(target))
                if missing or extra:
                    raise KeyError(f"missing {missing[:4]}, unexpected {extra[:4]}")
                for k, v in dense.items():
                    if v.shape != target[k].shape:
                        raise ValueError(f"{k}: shape {tuple(v.shape)}, expected {tuple(target[k].shape)}")
                owner.load_state_dict(dense)
            return True, "ok"
        except Exception as e:  # noqa: BLE001
            return False, f"update failed, rolled back: {e}"

    def forward_logits(self, wb: WorkerBatch) -> torch.Tensor:
        """The f32 logits [B_real, V] that one step of ``wb`` would sample
        from (its new K/V is written to the pool as in a real step)."""
        with torch.inference_mode():
            meta, _, _ = self._pad_to_buckets(wb)
            logits = self._forward(meta)[: len(wb.seq_lens)]
        if self.mesh is not None:
            self._logits_digest.update(logits.cpu().numpy().tobytes())
        return logits

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

    def _fetch(self, ids: torch.Tensor, chosen: torch.Tensor):
        """ONE device-to-host copy of ids [K, B] and their logprobs [K, B]
        (the f32 logprobs ride as their int32 bit patterns)."""
        both = torch.stack([ids.to(torch.int32), chosen.float().view(torch.int32)])
        host = both.cpu().numpy()
        self._record(host)
        return host[0], host[1].view(np.float32)

    # ------------------------------------------------------ tensor parallel

    def _record(self, host: np.ndarray) -> None:
        """Fold sampled ids and logprob bits (int32 [2, K, B]) into this
        rank's digest (tensor parallel only): every rank samples the same."""
        if self.mesh is not None:
            self._token_digest.update(np.ascontiguousarray(host).tobytes())
            self._tokens_sampled += host[0].size

    def reset_counts(self) -> None:
        """Set this rank's kernel launch counts, forward counts and
        collective count to 0."""
        from scratchpad_tpu_torch.ops import reset_launch_counts

        reset_launch_counts()
        self.forward_counts = dict.fromkeys(self.forward_counts, 0)
        if self.mesh is not None:
            self.mesh.collectives = 0

    def tp_report(self) -> dict:
        """What this rank has done since ``reset_counts``: kernel launches,
        forwards by mode and collectives (the W4 GEMMs' launches also by
        group size); with its placement, parameter bytes and the
        allocator's peak while they were loaded, pool, the digests of every token it sampled, of every
        ``forward_logits`` result and (MoE, tensor parallel) of every router
        pick, and the top-level packages it has imported."""
        from scratchpad_tpu_torch.ops import KERNEL_WRAPPERS

        tp = self.mesh
        return dict(
            rank=0 if tp is None else tp.rank, device=str(self.device),
            backend=None if tp is None else tp.backend,
            param_bytes=self.param_bytes, load_peak_bytes=self.load_peak_bytes,
            kv_tokens=self.max_total_num_tokens, kv_heads=self.kv_cache.num_kv_heads,
            launches={fn.__name__: fn.launches for fn in KERNEL_WRAPPERS},
            group_launches={fn.__name__: dict(fn.group_launches) for fn in KERNEL_WRAPPERS
                            if hasattr(fn, "group_launches")},
            forwards={m.name.lower(): n for m, n in self.forward_counts.items()},
            collectives=0 if tp is None else tp.collectives,
            tokens_sampled=self._tokens_sampled, token_digest=self._token_digest.hexdigest(),
            logits_digest=self._logits_digest.hexdigest(),
            # a MoE rank's router picks (parallel: every rank's the same)
            router_picks=getattr(self.model, "router_picks", None),
            router_digest=(None if getattr(self.model, "router_digest", None) is None
                           else int(self.model.router_digest)),
            packages=sorted({m.split(".")[0] for m in sys.modules}),
        )

    # -------------------------------------------------------------- bucketing

    def _pad_to_buckets(self, wb: WorkerBatch):
        """The batch as device tensors, the sampling state and its
        host-known modes (see ``sample``). A decode batch is padded to the
        batch-size and page-table buckets: its padding rows have
        ``seq_lens == extend_lens == 0``, write to the dump page 0 and take
        adapter slot 0, the zero adapter. An extend batch keeps its real
        size. Either is padded to ``MIN_ROWS`` requests and tokens."""
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
            B = max(B, MIN_ROWS)
            T = B
            P = _pow2_bucket(P_real, 4, self.max_pages_per_req)
        else:
            B, T, P = max(B_real, MIN_ROWS), max(T_real, MIN_ROWS), P_real

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
        d64 = self._upload(i64)
        d32 = self._upload(i32)
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
        self._upload_multimodal(wb, meta, B, T)

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
            # padding rows allow every token; the words go up as int32 (the
            # same bits), which every device's indexing and shifts take
            vocab_bitmask=None if wb.vocab_bitmask is None
            else padB(wb.vocab_bitmask, 0xFFFFFFFF).view(np.int32),
            custom_processors=si.custom_processors,
            # the mask is [P, B_real]: padding rows take no processor
            custom_proc_mask=None if si.custom_proc_mask is None
            else np.pad(si.custom_proc_mask, [(0, 0), (0, B - si.custom_proc_mask.shape[1])]),
            custom_proc_params=None if si.custom_proc_params is None
            else tuple({k: padB(v, 0.0) for k, v in d.items()} for d in si.custom_proc_params),
        )
        return meta, sinfo_host.map_arrays(self._upload), sinfo_host.modes(V)

    def _upload_multimodal(self, wb: WorkerBatch, meta: ForwardMeta, B: int, T: int) -> None:
        """The batch's multimodal fields on the device, padded to its B and
        T (padding rows: zero features, positions and spans); the spans go
        to the extend kernel through ``meta.mm_spans``."""
        T_real, B_real = len(wb.tokens), len(wb.seq_lens)
        if wb.input_embeds is not None:
            emb = np.zeros((T, wb.input_embeds.shape[1]), np.float32)
            emb[:T_real] = wb.input_embeds
            meta.input_embeds = self._upload(emb).to(self.dtype)
        if wb.mrope_positions is not None:
            mpos = np.zeros((3, T), np.int64)
            mpos[:, :T_real] = wb.mrope_positions
            meta.mrope_positions = self._upload(mpos)
        if wb.rope_delta is not None:
            delta = np.zeros(B, np.int64)
            delta[:B_real] = wb.rope_delta
            meta.rope_delta = self._upload(delta)
        if wb.mm_spans is not None:
            spans = np.zeros((B,) + wb.mm_spans.shape[1:], np.int32)
            spans[:B_real] = wb.mm_spans
            meta.mm_spans = self._upload(spans)
        if wb.cross_slots is not None:
            self._cross_fields(wb, meta)

    def _cross_fields(self, wb: WorkerBatch, meta: ForwardMeta) -> None:
        """The batch's requests with an image as ``CrossRequest``s, their
        rows from the host's extend lengths and positions, so no value
        comes back from the card (JAX :1463-1488)."""
        from scratchpad_tpu_torch.executor.forward_meta import CrossRequest

        first = np.cumsum(wb.extend_lens) - wb.extend_lens
        reqs = []
        for b, slot in enumerate(wb.cross_slots):
            if slot == 0:
                continue
            t0, n = int(first[b]), int(wb.extend_lens[b])
            before = int(wb.cross_starts[b]) - int(wb.positions[t0])
            reqs.append(CrossRequest(int(slot), t0, t0 + n, int(wb.cross_lens[b]), min(max(before, 0), n)))
        meta.cross_requests = tuple(reqs)

    def write_cross(self, slot: int, states: np.ndarray) -> None:
        """An admitted request's image, vision states f32 [S_img, H], as
        each cross layer's K and V in its slot of the cross buffer (JAX
        ``_write_cross``, which runs inside the first extend)."""
        with torch.inference_mode():
            self.model.write_cross(self.kv_cache, slot, self._upload(np.asarray(states, np.float32)))

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """``a`` on the runner's device. To the card it goes from a pinned
        copy without a host sync (torch's caching host allocator keeps the
        pinned block until the copy has run), so a window can be dispatched
        while earlier work still runs."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)
