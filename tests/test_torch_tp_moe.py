"""Tensor parallelism for the MoE text families (Mixtral, Qwen3-MoE,
GPT-OSS, Llama-4 text, DeepSeek-V2 and V3): the port's engine at tp 2 (two
gloo processes on the CPU) against the JAX package's engine at tp 2 and
against the port at tp 1, as ``test_torch_tp_families.py`` holds the dense
families (its helpers). This file holds Mixtral and Qwen3-MoE, and every
family's tiny config; GPT-OSS, Llama-4 and DeepSeek are in
``test_torch_tp_moe_gpt_oss.py``, ``test_torch_tp_moe_llama4.py`` and
``test_torch_tp_moe_deepseek.py`` (one family a file, so that the
six-worker run spreads them).

- Each tiny family in f32 against the JAX engine on a two-device CPU mesh,
  on the same perturbed weights (norms, biases, GPT-OSS's sinks and V3's
  correction bias moved at random): the same greedy ids up to a near tie
  (``MARGIN``), the chosen logprobs within 1e-4; Mixtral also on int8 KV
  (2e-4: ``test_torch_tp_families.LP_TOL``).
  On every rank: two collectives a layer and forward (o's sum and the
  experts' sum; GPT-OSS, whose experts are whole on every rank, one) plus
  the lookup's and the head's, and the same router picks, forwards and
  sampled ids as the leader's. DeepSeek keeps the whole latent pool on
  every rank.
- Llama-4 (dense and MoE layers in turn; its fused gate|up stack cut into
  each rank's gate and up shares) at tp 2 against tp 1 on the same seeded
  random weights: the same greedy ids and logprobs within 1e-4; every
  rank's digests of router picks, sampled ids and gathered logits equal the
  leader's.
"""

import pytest

import torch_threads  # noqa: F401  (one torch thread a test process)
from test_torch_tp_families import LLAMA_LIKE, TP, matches_the_jax_engine

MIXTRAL = dict(LLAMA_LIKE, architectures=["MixtralForCausalLM"], intermediate_size=96, num_local_experts=4,
               num_experts_per_tok=2)
QWEN3_MOE = dict(LLAMA_LIKE, architectures=["Qwen3MoeForCausalLM"], num_experts=4, num_experts_per_tok=2,
                 moe_intermediate_size=96, norm_topk_prob=True, decoder_sparse_step=1)
GPT_OSS = dict(
    architectures=["GptOssForCausalLM"], vocab_size=512, hidden_size=128, intermediate_size=96,
    num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2, head_dim=32, num_local_experts=4,
    num_experts_per_tok=2, sliding_window=8, layer_types=["sliding_attention", "full_attention"],
    attention_bias=True, max_position_embeddings=1024, rms_norm_eps=1e-5, tie_word_embeddings=False,
)
# Llama-4 with dense and MoE layers in turn, 10 query heads (5 a rank over
# one kv head), a chunk of 8 on its rope layers and a NoPE layer
LLAMA4 = dict(
    architectures=["Llama4ForCausalLM"], vocab_size=512, hidden_size=128, intermediate_size=96,
    intermediate_size_mlp=160, num_hidden_layers=4, num_attention_heads=10, num_key_value_heads=2,
    head_dim=32, num_local_experts=4, num_experts_per_tok=2, use_qk_norm=True,
    attn_temperature_tuning=True, floor_scale=8, attn_scale=0.1, attention_chunk_size=8,
    max_position_embeddings=1024, rms_norm_eps=1e-5, rope_theta=10000.0, tie_word_embeddings=False,
    no_rope_layers=[1, 1, 1, 0], interleave_moe_layer_step=2,
)
# DeepSeek: 1 dense layer, then 2 MoE layers of 8 routed experts (top 2) in
# 4 groups beside one shared expert; 4 heads (2 a rank), one latent pool
DEEPSEEK_V2 = dict(
    architectures=["DeepseekV2ForCausalLM"], vocab_size=512, hidden_size=64, intermediate_size=128,
    num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=4, max_position_embeddings=1280,
    rms_norm_eps=1e-5, rope_theta=10000.0, tie_word_embeddings=False, q_lora_rank=None, kv_lora_rank=32,
    qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16, n_routed_experts=8, num_experts_per_tok=2,
    moe_intermediate_size=32, n_shared_experts=1, first_k_dense_replace=1, routed_scaling_factor=1.0,
    norm_topk_prob=False, topk_method="greedy", n_group=4, topk_group=2,
)
DEEPSEEK_V3 = dict(DEEPSEEK_V2, architectures=["DeepseekV3ForCausalLM"], topk_method="noaux_tc",
                   norm_topk_prob=True, routed_scaling_factor=2.5, q_lora_rank=24)
MOE = {
    "mixtral": MIXTRAL, "qwen3-moe": QWEN3_MOE, "gpt-oss": GPT_OSS, "llama4": LLAMA4,
    "deepseek-v2": DEEPSEEK_V2, "deepseek-v3": DEEPSEEK_V3,
}


def matches_at_tp2(family: str, kv: str) -> None:
    """``family``'s engine at tp 2 against the JAX engine at tp 2
    (``matches_the_jax_engine``), its ranks' pools."""
    hf = MOE[family]
    reports = matches_the_jax_engine(hf, kv, per_layer=1 if family == "gpt-oss" else 2)
    assert reports[0]["router_picks"] > 0  # the same picks on every rank (rank_reports)
    if family.startswith("deepseek"):  # the whole latent pool on every rank
        assert all(rep["kv_heads"] == 1 for rep in reports)
    else:
        assert all(rep["kv_heads"] == hf["num_key_value_heads"] // TP for rep in reports)


@pytest.mark.parametrize(
    "family, kv", [("mixtral", "auto"), ("mixtral", "int8"), ("qwen3-moe", "auto")],
    ids=["mixtral", "mixtral-int8", "qwen3-moe"],
)
def test_tp2_matches_the_jax_engine_at_tp2(family, kv):
    matches_at_tp2(family, kv)
