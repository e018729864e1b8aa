"""The port's Qwen3-MoE against the JAX package's, on the CPU in f32, and
against HF transformers on the same random weights: ``tests/test_torch_moe.py``'s
tests (its helpers and tolerances) at Qwen3-MoE's variants, the per-head
qk-norm and ``norm_topk_prob`` on and off.
"""

import pytest

import test_torch_moe as moe


@pytest.mark.parametrize("variant", ["qwen3-moe", "qwen3-moe-unnormed"])
def test_logits_match_jax(variant):
    moe.test_logits_match_jax(variant)


@pytest.mark.parametrize("variant, quantization", [("qwen3-moe", "w4a16")])
def test_quantized_logits_match_jax(variant, quantization):
    moe.test_quantized_logits_match_jax(variant, quantization)


@pytest.mark.parametrize("variant", ["qwen3-moe"])
def test_engine_greedy_matches_jax(variant):
    moe.test_engine_greedy_matches_jax(variant)


@pytest.mark.parametrize("arch", ["Qwen3MoeForCausalLM"])
def test_logits_match_hf(arch):
    moe.test_logits_match_hf(arch)


@pytest.mark.parametrize("variant", ["qwen3-moe"])
def test_convert_hf_state_matches_jax(variant):
    moe.test_convert_hf_state_matches_jax(variant)
