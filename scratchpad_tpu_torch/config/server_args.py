"""Engine/server flags.

Counterpart of ``scratchpad_tpu.config.server_args`` for the PyTorch port:
the same flat dataclass drives the engine and the scheduler, and
``resolve()`` materialises derived defaults. It holds only the settings the
port reads, and the switches of features it does not have yet, which
``resolve()`` refuses with ``NotImplementedError`` when they are set. The
HTTP server's settings come with the HTTP surface (later work). The port
serves on one CUDA device (or the CPU, for tests).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


QUANTIZATIONS = (None, "w4a8", "w4a16", "w4", "awq", "gptq", "gptq_v2")
KV_CACHE_DTYPES = ("auto", "bfloat16", "int8", "fp8")
ATTENTION_BACKENDS = ("auto", "pallas")


@dataclasses.dataclass
class ServerArgs:
    # model / weights
    model_path: str = ""
    preset: Optional[str] = None  # built-in architecture preset (offline runs)
    tokenizer_path: Optional[str] = None
    dtype: str = "bfloat16"
    # None | w4a8 (4-bit weights, per-token int8 activations) | w4a16 (also
    # w4) | awq | gptq | gptq_v2 (import an AutoAWQ/AutoGPTQ int4
    # checkpoint bit-exact; random weights quantize the random init). fp8
    # is not ported yet
    quantization: Optional[str] = None
    # auto | bfloat16 (the model dtype) | int8 | fp8 (e4m3): 8-bit KV codes
    # with one bf16 scale per (token, head). auto picks int8 for W4 serving
    # of 3B and up on the card, as the JAX runner does
    # (executor/model_runner.resolve_kv_cache_dtype), and the model dtype
    # otherwise
    kv_cache_dtype: str = "auto"
    random_weights: bool = False  # initialise random weights (benchmarks)
    context_length: Optional[int] = None

    # scheduling (reference: server/args.py:23-45)
    schedule_policy: str = "lpm"  # lpm | fcfs | lof | random | dfs-weight
    chunked_prefill_size: int = 2048
    max_running_requests: int = 256
    max_prefill_tokens: int = 8192
    max_total_tokens: Optional[int] = None  # KV pool size in tokens
    schedule_conservativeness: float = 1.0
    enable_mixed_chunk: bool = False
    stream_interval: int = 1

    # memory
    page_size: int = 16  # tokens per KV page
    mem_fraction_static: float = 0.85
    disable_radix_cache: bool = False
    # not ported yet, refused when set: CPU parameter offload and the host
    # KV tier
    enable_param_offload: bool = False
    host_kv_cache_tokens: int = 0

    # parallelism: not ported yet, refused above 1 (the port serves on one
    # device)
    tp_size: int = 1
    dp_size: int = 1
    pp_size: int = 1
    sp_size: int = 1
    num_nodes: int = 1
    # decode batch-size buckets: decode batches are padded up to the next
    # one, the shapes CUDA graphs will be captured at (later work)
    decode_bs_buckets: Optional[list[int]] = None

    # decode windowing: K decode steps whose sampled ids stay on the device,
    # with one host fetch per window
    decode_window_size: int = 16

    # attention: auto = decode_attention_gqa + attention_ragged; pallas =
    # decode_attention_pallas (bf16 KV only) + attention_ragged. Both launch
    # the hand-written CUDA kernels for CUDA tensors and take their plain
    # PyTorch versions for CPU tensors. The JAX package's other backends
    # (xla, ragged, gqa, ...) are refused: on the card the plain path may
    # not serve
    attention_backend: str = "auto"

    # not ported yet, refused when set: decode-window pipelining, its
    # depth, speculative decoding (ngram | draft | eagle), sequence- and
    # pipeline-parallel execution, expert parallelism and DP attention
    enable_overlap: Optional[bool] = None
    decode_pipeline_depth: Optional[int] = None
    speculative_algorithm: Optional[str] = None
    speculative_num_draft_tokens: int = 4
    speculative_ngram_max: int = 3  # longest suffix n-gram to match
    enable_sp_prefill: bool = False
    enable_pp: bool = False
    enable_ep: bool = False
    enable_dp_attention: bool = False

    # abort requests whose logits go non-finite instead of streaming
    # garbage (reference: nn/layers/sampler.py:54-61 NaN detection)
    enable_nan_detection: bool = True

    # observability
    decode_log_interval: int = 40

    # misc
    random_seed: int = 0
    # torch device: "cuda" (the card; raises where none exists) | "cuda:N"
    # | "cpu" (the plain PyTorch path, used by the tests)
    device: str = "cuda"

    def resolve(self) -> "ServerArgs":
        """Materialise derived defaults; idempotent."""
        if self.speculative_algorithm == "none":
            self.speculative_algorithm = None
        if not (self.device == "cpu" or self.device.split(":")[0] == "cuda"):
            raise ValueError(f"device must be cuda, cuda:N or cpu; got {self.device!r}")
        self._refuse_unported()
        if self.attention_backend == "pallas" and self.kv_cache_dtype in ("int8", "fp8"):
            raise ValueError(
                f"attention_backend='pallas' decodes bf16 pages only, not "
                f"kv_cache_dtype={self.kv_cache_dtype!r} (use attention_backend='auto')"
            )
        if self.tokenizer_path is None:
            self.tokenizer_path = self.model_path or None
        if self.decode_bs_buckets is None:
            ladder = [1, 2, 4, 8, 16, 32, 64, 128, 256]
            self.decode_bs_buckets = [
                b for b in ladder if b <= max(self.max_running_requests, 1)
            ] or [1]
        return self

    def _refuse_unported(self) -> None:
        """Options whose code paths the port does not have yet."""
        unported = {
            "speculative_algorithm": self.speculative_algorithm is not None,
            "quantization": self.quantization not in QUANTIZATIONS,
            "kv_cache_dtype": self.kv_cache_dtype not in KV_CACHE_DTYPES,
            "enable_param_offload": self.enable_param_offload,
            "host_kv_cache_tokens": self.host_kv_cache_tokens > 0,
            "tp_size/dp_size/pp_size/sp_size": max(
                self.tp_size, self.dp_size, self.pp_size, self.sp_size
            )
            > 1,
            "num_nodes": self.num_nodes > 1,
            "enable_sp_prefill": self.enable_sp_prefill,
            "enable_pp": self.enable_pp,
            "enable_ep": self.enable_ep,
            "enable_dp_attention": self.enable_dp_attention,
            "enable_overlap": bool(self.enable_overlap),
            "decode_pipeline_depth": self.decode_pipeline_depth is not None,
            "attention_backend": self.attention_backend not in ATTENTION_BACKENDS,
        }
        bad = [k for k, v in unported.items() if v]
        if bad:
            raise NotImplementedError(
                f"not ported to scratchpad_tpu_torch yet: {', '.join(bad)}"
            )
