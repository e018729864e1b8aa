"""fp8 weights (``quantization="fp8"``) in the port against the JAX
package, on the CPU in f32:

- ``quantize_fp8_stacked``'s codes and scales bit for bit against the JAX
  function's (a layer stack and an expert stack, zero and tiny channels
  included), on numpy and on tensors;
- ``Fp8Linear`` against the JAX ``fp8_matmul`` (f32 to 1e-6; bf16 inputs to
  one bf16 rounding of the f32 result);
- the tiny-debug (Llama) and tiny-Mixtral engines on the JAX runner's own
  fp8 codes: greedy tokens equal, the chosen tokens' logprobs within 1e-4,
  each step's top-2 margin above the engine tests' ``MARGIN``;
- what keeps refusing fp8: Gemma, Llama-4, Apertus and DeepSeek, whose JAX
  classes read no fp8 layers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scratchpad_tpu.config import ServerArgs as JaxServerArgs
from scratchpad_tpu.config.model_config import get_preset as jax_get_preset
from scratchpad_tpu.ops.quant import fp8 as jax_fp8
from scratchpad_tpu.sampling.sampling_params import SamplingParams as JaxSamplingParams
from scratchpad_tpu.server.engine import Engine as JaxEngine
from scratchpad_tpu_torch.config import ServerArgs
from scratchpad_tpu_torch.config.model_config import ModelConfig, get_preset
from scratchpad_tpu_torch.executor.weight_loader import params_from_jax
from scratchpad_tpu_torch.models.registry import get_model_class
from scratchpad_tpu_torch.ops.quant.fp8 import Fp8ExpertStack, Fp8Linear, quantize_fp8_stacked
from scratchpad_tpu_torch.sampling.sampling_params import SamplingParams
from scratchpad_tpu_torch.server.engine import Engine
from test_torch_engine import MARGIN, _teacher_forced_margins
from test_torch_moe import ENGINE_ARGS, MIXTRAL
import torch_threads  # noqa: F401  (one torch thread a test process)

LP_TOL = 1e-4


def _weights(shape, seed):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(shape).astype(np.float32) * rng.uniform(0.01, 10, shape[-1]).astype(np.float32)
    w[..., 0, 3] = 0.0  # one code of every matrix at zero
    w.reshape(-1, *shape[-2:])[0, :, 5] = 0.0  # an all-zero channel: the 1e-12 floor
    w.reshape(-1, *shape[-2:])[0, :, 6] *= 1e-30  # a tiny channel
    return w


@pytest.mark.parametrize("shape", [(3, 64, 48), (2, 3, 32, 16)], ids=["layers", "experts"])
def test_codes_match_jax_bit_for_bit(shape):
    w = _weights(shape, seed=len(shape))
    ref = jax_fp8.quantize_fp8_stacked(w)
    jcodes = np.asarray(ref.w8).view(np.uint8)
    for src in (w, torch.from_numpy(w)):
        codes, scales = quantize_fp8_stacked(src)
        assert codes.dtype == torch.float8_e4m3fn
        np.testing.assert_array_equal(codes.view(torch.uint8).numpy(), jcodes)
        np.testing.assert_array_equal(scales.numpy(), np.asarray(ref.s))


def test_fp8_linear_matches_fp8_matmul():
    w = _weights((2, 96, 40), seed=3)
    ref = jax_fp8.quantize_fp8_stacked(w)
    codes, scales = quantize_fp8_stacked(w)
    lin = Fp8Linear(96, 40, bias=False, device="cpu", dtype=torch.float32)
    lin.load_state_dict({"w8": codes[1], "s": scales[1]})
    x = np.random.default_rng(4).standard_normal((7, 96)).astype(np.float32)
    want = np.asarray(jax_fp8.fp8_matmul(jnp.asarray(x), ref, 1))
    np.testing.assert_allclose(lin(torch.from_numpy(x)).numpy(), want, rtol=1e-6, atol=1e-6)
    # bf16 activations: one rounding of the scaled f32 product
    xb = jnp.asarray(x, jnp.bfloat16)
    want16 = np.asarray(jax_fp8.fp8_matmul(xb, ref, 1).astype(jnp.float32))
    got16 = lin(torch.from_numpy(x).to(torch.bfloat16)).float().numpy()
    np.testing.assert_allclose(got16, want16, rtol=2**-7, atol=1e-6)
    # an expert stack is every expert's Fp8Linear
    stack = Fp8ExpertStack(2, 96, 40, device="cpu")
    stack.load_state_dict({"w8": codes, "s": scales})
    both = stack(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(both[1], want, rtol=1e-6, atol=1e-6)


def _engine_pair(model_kw):
    """The JAX engine quantizes its random f32 init to fp8; the port loads
    those codes through ``params_from_jax``."""
    args = dict(ENGINE_ARGS, chunked_prefill_size=16, quantization="fp8")
    jeng = JaxEngine(JaxServerArgs(**args, warmup_capture=False),
                     model_config=jax_get_preset("tiny-debug", dtype="float32", **model_kw))
    params = jax.tree.map(np.asarray, jeng.scheduler.runner.params)
    eng = Engine(ServerArgs(device="cpu", **args),
                 model_config=get_preset("tiny-debug", dtype="float32", **model_kw))
    eng.scheduler.runner.model.load_state_dict(params_from_jax(params, eng.model_config))
    return jeng, eng, params


@pytest.mark.parametrize("model_kw", [{}, MIXTRAL], ids=["llama", "mixtral"])
def test_fp8_engine_matches_jax(model_kw):
    """Three prompts (the 40-token one in three chunks), then a radix hit:
    the same greedy tokens and logprobs; the port holds e4m3 codes, the
    head in f32, and the experts as one fp8 stack a matrix."""
    jeng, eng, params = _engine_pair(model_kw)
    model = eng.scheduler.runner.model
    assert "lm_head_q" not in params and model.lm_head is not None
    layer = model.layers[0]
    assert isinstance(layer.wq, Fp8Linear) and layer.wq.w8.dtype == torch.float8_e4m3fn
    if model_kw:
        assert isinstance(layer.w1, Fp8ExpertStack)
    else:
        assert isinstance(layer.gate, Fp8Linear) and not layer.fused_gate_up
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, 500, n).tolist() for n in (5, 23, 40)]
    again = prompts[2][:32] + rng.integers(1, 500, 4).tolist()
    sp = SamplingParams(temperature=0.0, max_new_tokens=10)
    jsp = JaxSamplingParams(temperature=0.0, max_new_tokens=10)
    outs = eng.generate(input_ids=prompts + [again], sampling_params=[sp] * 4, return_logprob=True)
    jouts = jeng.generate(input_ids=prompts + [again], sampling_params=[jsp] * 4, return_logprob=True)
    for p, o, j in zip(prompts + [again], outs, jouts):
        ids, margins = _teacher_forced_margins(eng, p, o.output_ids)
        assert ids == o.output_ids and min(margins) > MARGIN, min(margins)
        assert o.output_ids == j.output_ids
        np.testing.assert_allclose(o.output_token_logprobs, j.output_token_logprobs,
                                   rtol=LP_TOL, atol=LP_TOL)
    eng.scheduler.check_memory_leak()


DEEPSEEK = {"architectures": ["DeepseekV2ForCausalLM"], "vocab_size": 512, "hidden_size": 64,
            "intermediate_size": 128, "num_hidden_layers": 2, "num_attention_heads": 4,
            "num_key_value_heads": 4, "kv_lora_rank": 32, "qk_nope_head_dim": 16,
            "qk_rope_head_dim": 8, "v_head_dim": 16, "n_routed_experts": 4,
            "num_experts_per_tok": 2, "moe_intermediate_size": 32, "first_k_dense_replace": 1}


@pytest.mark.parametrize("cfg", [
    lambda: get_preset("tiny-gemma2"),
    lambda: get_preset("tiny-debug", architecture="Llama4ForCausalLM", num_experts=4,
                       num_experts_per_tok=1, attention_chunk_size=4),
    lambda: get_preset("tiny-debug", architecture="ApertusForCausalLM"),
    lambda: ModelConfig.from_hf_config(DEEPSEEK),
], ids=["gemma", "llama4", "apertus", "deepseek"])
def test_fp8_refused_where_jax_reads_no_fp8_layers(cfg):
    cfg = cfg()
    with pytest.raises(NotImplementedError, match="quantization"):
        get_model_class(cfg.architecture)(cfg, torch.device("cpu"), torch.float32, quantization="fp8")
