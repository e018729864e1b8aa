"""Engine/server flags.

Counterpart of ``scratchpad_tpu.config.server_args`` for the PyTorch port:
the same flat dataclass drives the engine and the scheduler, and
``resolve()`` materialises derived defaults. It holds only the settings the
port reads, the HTTP server's among them, and the switches of features it
does not have yet, which ``resolve()`` refuses with ``NotImplementedError``
when they are set. The port serves on one CUDA device (or the CPU, for
tests).
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional


QUANTIZATIONS = (None, "w4a8", "w4a16", "w4", "awq", "gptq", "gptq_v2", "fp8")
KV_CACHE_DTYPES = ("auto", "bfloat16", "int8", "fp8")
ATTENTION_BACKENDS = ("auto", "pallas")


@dataclasses.dataclass
class ServerArgs:
    # model / weights
    model_path: str = ""
    preset: Optional[str] = None  # built-in architecture preset (offline runs)
    tokenizer_path: Optional[str] = None  # "chars", where no such path exists: tokenizer/chars.py
    dtype: str = "bfloat16"
    # None | w4a8 (4-bit weights, per-token int8 activations) | w4a16 (also
    # w4) | awq | gptq | gptq_v2 (import an AutoAWQ/AutoGPTQ int4
    # checkpoint bit-exact; random weights quantize the random init) | fp8
    # (e4m3 codes with one f32 scale per output channel, quantized at load)
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
    # seconds without scheduler progress, with requests in flight, before
    # the async runner fails them (server/async_runner.py)
    watchdog_timeout: float = 120.0
    # multi-turn session store bounds (Engine.open_session): LRU capacity
    # and idle TTL in seconds (<= 0: never expire)
    max_sessions: int = 1024
    session_ttl: float = 3600.0

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

    # decode-window pipelining: the next window is dispatched, chained on
    # the device to the previous window's last ids, before the previous
    # window's ids reach the host. None = auto: on where the runner's device
    # is CUDA, off on the CPU (the JAX rule: no mesh, not the CPU)
    enable_overlap: Optional[bool] = None
    # windows in flight when overlapping; None = 2
    decode_pipeline_depth: Optional[int] = None

    # not ported yet, refused when set: speculative decoding (ngram | draft
    # | eagle), sequence- and pipeline-parallel execution, expert
    # parallelism and DP attention
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

    # server (server/http_server.py)
    host: str = "127.0.0.1"
    port: int = 3000
    served_model_name: Optional[str] = None  # None: the preset or model_path
    chat_template: Optional[str] = None  # a conversation.py template name
    api_key: Optional[str] = None  # Bearer token every /v1 route asks for
    # split <think> spans into `reasoning_content` while streaming chat.
    # None = off; "deepseek-r1" starts inside a think block; any other
    # value splits on explicit tags only
    reasoning_parser: Optional[str] = None
    # emit reasoning deltas as they come; False holds each think block
    stream_reasoning: bool = True
    # decode per-request custom logit processors sent over HTTP (a pickled
    # payload: unpickling runs arbitrary code); without it the server
    # answers 400 to a request that names one
    enable_custom_logit_processor: bool = False

    # constrained decoding (regex, json_schema, ebnf, structural_tag): the
    # native regex/json FSM engine, its token walk in csrc/fsm.cpp and
    # csrc/pda.cpp
    grammar_backend: str = "native"

    # multimodal chat: the text each image or video part becomes before the
    # chat template, and the frames sampled from a video
    mm_image_token: str = "<image>"
    mm_video_token: str = "<video>"
    video_frames: int = 8

    # observability
    enable_metrics: bool = True  # /metrics, Prometheus text exposition
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
        if self.grammar_backend != "native":
            raise ValueError(f"grammar_backend must be 'native'; got {self.grammar_backend!r}")
        if self.decode_pipeline_depth is not None and self.decode_pipeline_depth < 1:
            raise ValueError(f"decode_pipeline_depth must be >= 1; got {self.decode_pipeline_depth}")
        if self.served_model_name is None:
            self.served_model_name = self.preset or self.model_path or "model"
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
            "attention_backend": self.attention_backend not in ATTENTION_BACKENDS,
        }
        bad = [k for k, v in unported.items() if v]
        if bad:
            raise NotImplementedError(
                f"not ported to scratchpad_tpu_torch yet: {', '.join(bad)}"
            )

    @classmethod
    def add_cli_args(cls, parser: argparse.ArgumentParser) -> None:
        """One ``--flag-name`` for each field, as the JAX package's CLI has."""
        for f in dataclasses.fields(cls):
            name = "--" + f.name.replace("_", "-")
            ann = str(f.type)
            if isinstance(f.default, bool) or ann == "bool":
                parser.add_argument(name, action=argparse.BooleanOptionalAction, default=f.default)
            elif ann == "Optional[bool]":
                parser.add_argument(name, type=_parse_bool, default=f.default)
            elif "list" in ann:
                parser.add_argument(
                    name, type=lambda v: [int(x) for x in v.split(",")], default=f.default
                )
            elif "int" in ann:
                parser.add_argument(name, type=int, default=f.default)
            elif "float" in ann:
                parser.add_argument(name, type=float, default=f.default)
            else:
                parser.add_argument(name, type=str, default=f.default)

    @classmethod
    def from_cli_args(cls, args: argparse.Namespace) -> "ServerArgs":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in vars(args).items() if k in names}).resolve()


def _parse_bool(v: str) -> bool:
    if v.lower() in ("1", "true", "yes", "on"):
        return True
    if v.lower() in ("0", "false", "no", "off"):
        return False
    raise argparse.ArgumentTypeError(f"expected true or false, got {v!r}")
