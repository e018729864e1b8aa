"""Model architecture configuration.

Copy of ``scratchpad_tpu.config.model_config`` for the PyTorch port
(reference: scratchpad/config/model_config.py, scratchpad/config/vllm_model_config.py).
Reads a HuggingFace ``config.json`` from a local checkpoint directory, or uses a
built-in preset; no network access is assumed anywhere.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Optional


LLAMA4_ARCHITECTURES = ("Llama4ForCausalLM", "Llama4TextModel")


@dataclasses.dataclass
class ModelConfig:
    """Architecture of a decoder-only transformer.

    Field names follow HF conventions so a config.json maps directly.
    """

    architecture: str = "LlamaForCausalLM"
    vocab_size: int = 32000
    hidden_size: int = 2048
    intermediate_size: int = 5632
    num_hidden_layers: int = 22
    num_attention_heads: int = 32
    num_key_value_heads: int = 4
    head_dim: Optional[int] = None
    hidden_act: str = "silu"
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    rope_scaling: Optional[dict] = None
    tie_word_embeddings: bool = False
    attention_bias: bool = False
    mlp_bias: bool = False
    # Gemma-style options
    logit_softcap: Optional[float] = None
    attn_logit_softcap: Optional[float] = None
    sliding_window: Optional[int] = None
    sliding_window_pattern: Optional[int] = None
    # per-layer attention kinds (HF layer_types: "sliding_attention" /
    # "full_attention" / "chunked_attention"), e.g. GPT-OSS / Llama4
    layer_types: Optional[list] = None
    # Llama4 text options
    intermediate_size_mlp: Optional[int] = None  # dense layers' ffw width
    no_rope_layers: Optional[list] = None  # 1 = rope, 0 = NoPE
    no_rope_layer_interval: int = 4  # without the list: every this many-th layer is NoPE
    attention_chunk_size: Optional[int] = None
    floor_scale: float = 8192.0
    attn_scale: float = 0.1
    moe_layers: Optional[list] = None  # layer indices with experts
    interleave_moe_layer_step: int = 1
    attn_temperature_tuning: bool = True
    query_pre_attn_scalar: Optional[float] = None
    # Qwen3-style qk-norm
    use_qk_norm: bool = False
    # MoE options (0 experts = dense)
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_intermediate_size: Optional[int] = None
    norm_topk_prob: bool = False
    # DeepSeek-style MoE extensions
    n_shared_experts: int = 0
    first_k_dense_replace: int = 0
    routed_scaling_factor: float = 1.0
    topk_method: str = "greedy"  # greedy | group_limited_greedy
    n_group: int = 1
    topk_group: int = 1
    # MLA (multi-head latent attention, DeepSeek V2/V3)
    q_lora_rank: Optional[int] = None
    kv_lora_rank: Optional[int] = None
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    # multimodal (VLM): vision_config dict + image token / feature options
    multimodal: Optional[dict] = None
    # Mllama: decoder layer indices that are CROSS-attention layers
    cross_attention_layers: Optional[list] = None
    # bookkeeping
    model_path: Optional[str] = None
    dtype: str = "bfloat16"
    quantization: Optional[str] = None  # None | "w4a16" | "w8a16" | "fp8"
    kv_cache_dtype: str = "auto"  # auto | bfloat16 | int8 | fp8

    def __post_init__(self):
        if self.head_dim is None:
            self.head_dim = self.hidden_size // self.num_attention_heads
        if self.architecture in LLAMA4_ARCHITECTURES and not self.no_rope_layers:
            # HF Llama4TextConfig: a list left out or empty makes every
            # no_rope_layer_interval-th layer NoPE (the JAX copy reads it as
            # all rope layers)
            self.no_rope_layers = [
                int((l + 1) % self.no_rope_layer_interval != 0) for l in range(self.num_hidden_layers)
            ]

    @property
    def num_kv_heads(self) -> int:
        return self.num_key_value_heads

    @property
    def is_mla(self) -> bool:
        return bool(self.kv_lora_rank)

    @property
    def context_len(self) -> int:
        return self.max_position_embeddings

    @classmethod
    def from_hf_config(cls, cfg: dict[str, Any], **overrides) -> "ModelConfig":
        """Build from a parsed HF config.json dict, ignoring unknown keys."""
        arch = (cfg.get("architectures") or ["LlamaForCausalLM"])[0]
        _MM_KEYS = (
            "vision_config",
            "image_token_index",
            "image_token_id",
            "vision_start_token_id",
            "video_token_id",
            "vision_feature_layer",
            "vision_feature_select_strategy",
            "projector_hidden_act",
            "image_size",
            "mm_tokens_per_image",
        )
        if "text_config" in cfg and isinstance(cfg["text_config"], dict):
            # VLM configs (Llava-style) nest the LM config; flatten it and
            # carry the vision half in `multimodal`
            mm = {k: cfg[k] for k in _MM_KEYS if k in cfg}
            cfg = {**cfg["text_config"], "architectures": [arch], "multimodal": mm}
        elif "vision_config" in cfg and isinstance(cfg["vision_config"], dict):
            # flat VLM configs (Qwen2-VL checkpoint format): text fields at
            # top level, vision half + token ids moved into `multimodal`
            mm = {k: cfg[k] for k in _MM_KEYS if k in cfg}
            cfg = {**cfg, "architectures": [arch], "multimodal": mm}
        field_names = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in cfg.items() if k in field_names}
        kwargs["architecture"] = arch
        # HF field-name variants
        if "n_routed_experts" in cfg and cfg["n_routed_experts"]:
            kwargs["num_experts"] = cfg["n_routed_experts"]
        if "num_local_experts" in cfg and cfg["num_local_experts"]:
            kwargs["num_experts"] = cfg["num_local_experts"]  # HF Mixtral
        if cfg.get("n_shared_experts") is None:
            kwargs.pop("n_shared_experts", None)
        # Qwen2-style configs carry a sliding_window VALUE but gate it off
        if cfg.get("use_sliding_window") is False:
            kwargs.pop("sliding_window", None)
        # HF variants of softcap naming (Gemma2)
        if "final_logit_softcapping" in cfg:
            kwargs["logit_softcap"] = cfg["final_logit_softcapping"]
        if "attn_logit_softcapping" in cfg:
            kwargs["attn_logit_softcap"] = cfg["attn_logit_softcapping"]
        kwargs.update(overrides)
        return cls(**kwargs)

    @classmethod
    def from_pretrained(cls, model_path: str, **overrides) -> "ModelConfig":
        """Load from a local checkpoint dir containing config.json."""
        cfg_path = os.path.join(model_path, "config.json")
        with open(cfg_path) as f:
            cfg = json.load(f)
        mc = cls.from_hf_config(cfg, **overrides)
        mc.model_path = model_path
        return mc

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)


# Built-in presets so benchmarks run without any network access.
PRESETS: dict[str, dict[str, Any]] = {
    "llama-3.2-1b": dict(
        architecture="LlamaForCausalLM",
        vocab_size=128256, hidden_size=2048, intermediate_size=8192,
        num_hidden_layers=16, num_attention_heads=32, num_key_value_heads=8,
        head_dim=64, max_position_embeddings=131072, rms_norm_eps=1e-5,
        rope_theta=500000.0, tie_word_embeddings=True,
        rope_scaling={"rope_type": "llama3", "factor": 32.0,
                      "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                      "original_max_position_embeddings": 8192},
    ),
    # 3B: bf16 (~6.4 GiB of weights) and W4 both fit one device, so the
    # quantized-vs-bf16 decode ratio can be measured within one run
    "llama-3.2-3b": dict(
        architecture="LlamaForCausalLM",
        vocab_size=128256, hidden_size=3072, intermediate_size=8192,
        num_hidden_layers=28, num_attention_heads=24, num_key_value_heads=8,
        head_dim=128, max_position_embeddings=131072, rms_norm_eps=1e-5,
        rope_theta=500000.0, tie_word_embeddings=True,
        rope_scaling={"rope_type": "llama3", "factor": 32.0,
                      "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                      "original_max_position_embeddings": 8192},
    ),
    "llama-3.1-8b": dict(
        architecture="LlamaForCausalLM",
        vocab_size=128256, hidden_size=4096, intermediate_size=14336,
        num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
        head_dim=128, max_position_embeddings=131072, rms_norm_eps=1e-5,
        rope_theta=500000.0,
        rope_scaling={"rope_type": "llama3", "factor": 8.0,
                      "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                      "original_max_position_embeddings": 8192},
    ),
    "llama-3.1-70b": dict(
        architecture="LlamaForCausalLM",
        vocab_size=128256, hidden_size=8192, intermediate_size=28672,
        num_hidden_layers=80, num_attention_heads=64, num_key_value_heads=8,
        head_dim=128, max_position_embeddings=131072, rms_norm_eps=1e-5,
        rope_theta=500000.0,
        rope_scaling={"rope_type": "llama3", "factor": 8.0,
                      "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                      "original_max_position_embeddings": 8192},
    ),
    "qwen3-8b": dict(
        architecture="Qwen3ForCausalLM",
        vocab_size=151936, hidden_size=4096, intermediate_size=12288,
        num_hidden_layers=36, num_attention_heads=32, num_key_value_heads=8,
        head_dim=128, max_position_embeddings=40960, rms_norm_eps=1e-6,
        rope_theta=1000000.0, use_qk_norm=True,
    ),
    "qwen2-vl-2b": dict(
        architecture="Qwen2VLForConditionalGeneration",
        vocab_size=151936, hidden_size=1536, intermediate_size=8960,
        num_hidden_layers=28, num_attention_heads=12, num_key_value_heads=2,
        head_dim=128, max_position_embeddings=32768, rms_norm_eps=1e-6,
        rope_theta=1000000.0, tie_word_embeddings=True,
        rope_scaling={"type": "mrope", "mrope_section": [16, 24, 24]},
        multimodal=dict(
            vision_config=dict(
                embed_dim=1280, depth=32, num_heads=16, mlp_ratio=4,
                in_channels=3, patch_size=14, spatial_merge_size=2,
                temporal_patch_size=2, hidden_size=1536,
            ),
            image_token_id=151655, vision_start_token_id=151652,
            image_size=448,
        ),
    ),
    "tiny-debug": dict(
        architecture="LlamaForCausalLM",
        vocab_size=512, hidden_size=128, intermediate_size=256,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        head_dim=32, max_position_embeddings=1024, rope_theta=10000.0,
    ),
    # GPT-OSS-20B geometry (random weights): sinks + alternating 128-wide
    # sliding / full layers; exercises the gqa_xla dynamic-mask decode
    "gpt-oss-20b": dict(
        architecture="GptOssForCausalLM",
        vocab_size=201088, hidden_size=2880, intermediate_size=2880,
        num_hidden_layers=24, num_attention_heads=64, num_key_value_heads=8,
        head_dim=64, num_experts=32, num_experts_per_tok=4,
        sliding_window=128, max_position_embeddings=131072,
        rms_norm_eps=1e-5, rope_theta=150000.0, attention_bias=True,
        rope_scaling={"rope_type": "yarn", "factor": 32.0,
                      "original_max_position_embeddings": 4096,
                      "beta_fast": 32.0, "beta_slow": 1.0},
    ),
    # Gemma-2-2B geometry (random weights): alternating 4096-wide sliding /
    # full layers with logit softcaps
    "gemma-2-2b": dict(
        architecture="Gemma2ForCausalLM",
        vocab_size=256000, hidden_size=2304, intermediate_size=9216,
        num_hidden_layers=26, num_attention_heads=8, num_key_value_heads=4,
        head_dim=256, max_position_embeddings=8192, rms_norm_eps=1e-6,
        rope_theta=10000.0, query_pre_attn_scalar=256, sliding_window=4096,
        attn_logit_softcap=50.0, logit_softcap=30.0,
        tie_word_embeddings=True,
    ),
    "tiny-gpt-oss": dict(
        architecture="GptOssForCausalLM",
        vocab_size=512, hidden_size=128, intermediate_size=96,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        head_dim=32, num_experts=4, num_experts_per_tok=2, sliding_window=8,
        layer_types=["sliding_attention", "full_attention"],
        attention_bias=True, max_position_embeddings=1024,
        rms_norm_eps=1e-5,
    ),
    "tiny-gemma2": dict(
        architecture="Gemma2ForCausalLM",
        vocab_size=512, hidden_size=128, intermediate_size=256,
        num_hidden_layers=4, num_attention_heads=4, num_key_value_heads=2,
        head_dim=32, max_position_embeddings=1024, rms_norm_eps=1e-5,
        rope_theta=10000.0, query_pre_attn_scalar=32, sliding_window=16,
        attn_logit_softcap=50.0, logit_softcap=30.0,
        tie_word_embeddings=True,
    ),
}


def get_preset(name: str, **overrides) -> ModelConfig:
    key = name.lower()
    if key not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; have {sorted(PRESETS)}")
    kw = dict(PRESETS[key])
    kw.update(overrides)
    return ModelConfig(**kw)
