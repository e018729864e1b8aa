"""The vision models' engines in the port against the JAX package's, on the
CPU in f32, from one seeded parameter pytree (the JAX runner's random init,
through ``params_from_jax``):

- LLaVA, Qwen2-VL (one image, two images in one request, a video of four
  frames, text only) and Gemma 3 multimodal (two images, bidirectional
  spans, sliding windows of 8) give the JAX engines' greedy tokens, the
  chosen tokens' logprobs within 1e-4;
- two images behind one prompt never alias in the radix cache: the second
  request reuses only the text before the image, and answers otherwise;
- a chunked prefill that would split a Gemma 3 span is clamped to keep it
  whole and gives the unchunked tokens;
- a presence penalty on an image request counts only the prompt's real
  ids (the placeholders are negative), where the JAX engine raises;
- the refusals: images for a text model, images and a video together,
  negative ids from the caller, Mllama.
"""

import jax
import numpy as np
import pytest

from scratchpad_tpu.config import ServerArgs as JaxServerArgs
from scratchpad_tpu.config.model_config import ModelConfig as JaxModelConfig
from scratchpad_tpu.sampling.sampling_params import SamplingParams as JaxSamplingParams
from scratchpad_tpu.server.engine import Engine as JaxEngine
from scratchpad_tpu_torch.config import ServerArgs
from scratchpad_tpu_torch.config.model_config import ModelConfig
from scratchpad_tpu_torch.executor.weight_loader import params_from_jax
from scratchpad_tpu_torch.models.registry import get_model_class
from scratchpad_tpu_torch.sampling.sampling_params import SamplingParams
from scratchpad_tpu_torch.server.engine import Engine
from test_torch_vision import (
    GEMMA_IMG,
    LLAVA_IMG,
    QWEN_IMG,
    QWEN_VEND,
    QWEN_VID,
    QWEN_VSTART,
    model_kw,
    pixels,
)
import torch_threads  # noqa: F401  (one torch thread a test process)

LP_TOL = 1e-4
ARGS = dict(random_weights=True, dtype="float32", page_size=4, max_total_tokens=2048,
            chunked_prefill_size=64)


def engine_pair(family: str, **args):
    args = dict(ARGS, **args)
    jeng = JaxEngine(JaxServerArgs(**args, warmup_capture=False),
                     model_config=JaxModelConfig(**model_kw(family), dtype="float32"))
    params = jax.tree.map(np.asarray, jeng.scheduler.runner.params)
    eng = Engine(ServerArgs(device="cpu", **args), model_config=ModelConfig(**model_kw(family), dtype="float32"))
    eng.scheduler.runner.model.load_state_dict(params_from_jax(params, eng.model_config))
    return jeng, eng


def both_generate(jeng, eng, prompts, images, videos=None, n_new=8):
    videos = videos or [None] * len(prompts)
    sp = SamplingParams(temperature=0.0, max_new_tokens=n_new)
    jsp = JaxSamplingParams(temperature=0.0, max_new_tokens=n_new)
    outs = eng.generate(input_ids=prompts, sampling_params=[sp] * len(prompts), image_data=images,
                        video_data=videos, return_logprob=True)
    jouts = jeng.generate(input_ids=prompts, sampling_params=[jsp] * len(prompts), image_data=images,
                          video_data=videos, return_logprob=True)
    for o, j in zip(outs, jouts):
        assert len(o.output_ids) == n_new
        assert o.output_ids == j.output_ids
        np.testing.assert_allclose(o.output_token_logprobs, j.output_token_logprobs,
                                   rtol=LP_TOL, atol=LP_TOL)
    return outs


def test_llava_engine_matches_jax():
    """An image request, a two-image request and a text request in one
    batch; then the first prompt with another image: no radix aliasing."""
    jeng, eng = engine_pair("llava")
    px = pixels("llava", 3, seed=5)
    prompts = [[3, 7, LLAVA_IMG, 9, 11, 2], [5, LLAVA_IMG, 6, LLAVA_IMG, 8], [4, 10, 12, 14]]
    outs = both_generate(jeng, eng, prompts, [px[0], px[1:3], None])
    again = eng.generate(input_ids=prompts[0], image_data=px[2],
                         sampling_params=SamplingParams(temperature=0.0, max_new_tokens=8))
    assert again.cached_tokens <= 2  # the text before the image, page-aligned
    assert again.output_ids != outs[0].output_ids
    eng.scheduler.check_memory_leak()


def test_qwen2vl_engine_matches_jax():
    """One image, two images, a video of four frames and text only, each
    through multimodal rope (then the shifted 1-D rope of decode)."""
    jeng, eng = engine_pair("qwen2vl")
    px = pixels("qwen2vl", 3, seed=6)
    frames = pixels("qwen2vl", 4, seed=7)
    img = [QWEN_VSTART, QWEN_IMG, QWEN_VEND]
    prompts = [[3] + img + [7, 9], [5] + img + [6] + img + [8], [4] + [QWEN_VSTART, QWEN_VID, QWEN_VEND] + [2],
               [4, 10, 12, 14]]
    both_generate(jeng, eng, prompts, [px[0], px[1:3], None, None], [None, None, frames, None])
    eng.scheduler.check_memory_leak()


def test_gemma3_engine_matches_jax():
    """Two images (four-token spans) in one prompt, with the sliding window
    on the local layers; a chunk of 6 would split the first span and is
    clamped."""
    prompt = [3, 7, 9, 11, 2, GEMMA_IMG, 4, GEMMA_IMG, 6, 8, 12, 14]
    px = pixels("gemma3", 2, seed=8)
    jeng, eng = engine_pair("gemma3")
    whole = both_generate(jeng, eng, [prompt, [4, 10, 12]], [px, None])[0].output_ids
    _, chunked = engine_pair("gemma3", chunked_prefill_size=6)
    out = chunked.generate(input_ids=prompt, image_data=px,
                           sampling_params=SamplingParams(temperature=0.0, max_new_tokens=8))
    assert out.output_ids == whole
    chunked.scheduler.check_memory_leak()


def test_penalty_on_an_image_prompt():
    """A presence penalty marks the prompt's real ids only: the port serves
    it, and the penalty moves the answer's logprobs. The JAX engine marks
    ``in_mask[i, origin_input_ids]`` with the negative placeholders and
    raises (ROADMAP Queue 3)."""
    jeng, eng = engine_pair("llava")
    px = pixels("llava", 1, seed=9)
    prompt = [3, 7, LLAVA_IMG, 9, 11, 2]
    plain = eng.generate(input_ids=prompt, image_data=px, return_logprob=True,
                         sampling_params=SamplingParams(temperature=0.0, max_new_tokens=6))
    pen = eng.generate(input_ids=prompt, image_data=px, return_logprob=True,
                       sampling_params=SamplingParams(temperature=0.0, max_new_tokens=6,
                                                      presence_penalty=1.5))
    assert len(pen.output_ids) == 6 and pen.output_token_logprobs != plain.output_token_logprobs
    with pytest.raises(IndexError):
        jeng.generate(input_ids=prompt, image_data=px,
                      sampling_params=JaxSamplingParams(temperature=0.0, max_new_tokens=6,
                                                        presence_penalty=1.5))


def test_multimodal_refusals():
    small = dict(ARGS, max_total_tokens=256)
    text = Engine(ServerArgs(device="cpu", preset="tiny-debug", **small))
    with pytest.raises(ValueError, match="does not accept"):
        text.generate(input_ids=[1, 2, 3], image_data=pixels("llava", 1))
    with pytest.raises(ValueError, match="non-negative"):
        text.generate(input_ids=[1, -2, 3])
    eng = Engine(ServerArgs(device="cpu", **small), model_config=ModelConfig(**model_kw("qwen2vl"),
                                                                             dtype="float32"))
    with pytest.raises(ValueError, match="not both"):
        eng.generate(input_ids=[QWEN_IMG, QWEN_VID], image_data=pixels("qwen2vl", 1),
                     video_data=pixels("qwen2vl", 2))
    with pytest.raises(ValueError, match="image tokens"):
        eng.generate(input_ids=[QWEN_IMG, QWEN_IMG], image_data=pixels("qwen2vl", 1))
    with pytest.raises(NotImplementedError, match="next slice"):
        get_model_class("MllamaForConditionalGeneration")


def test_multimodal_batches_never_run_as_pipelined_windows():
    """Each of the four multimodal fields keeps a batch off the pipelined
    path (the JAX rule, ``model_runner.py:1067-1084``)."""
    from scratchpad_tpu_torch.executor.forward_meta import ForwardMode
    from scratchpad_tpu_torch.executor.model_runner import WorkerBatch
    from scratchpad_tpu_torch.sampling.batch_info import SamplingBatchInfo

    eng = Engine(ServerArgs(device="cpu", preset="tiny-debug", **dict(ARGS, max_total_tokens=256)))
    runner = eng.scheduler.runner
    base = dict(mode=ForwardMode.DECODE, tokens=np.ones(2, np.int32), positions=np.ones(2, np.int32),
                out_cache_loc=np.ones(2, np.int32), req_indices=np.arange(2), page_table=np.ones((2, 1), np.int32),
                seq_lens=np.full(2, 2), extend_lens=np.ones(2, np.int32),
                sampling_info=SamplingBatchInfo.from_reqs([], 2, 512))
    assert runner._packed_supported(WorkerBatch(**base))
    for field, value in (("input_embeds", np.zeros((2, 128), np.float32)),
                         ("mrope_positions", np.zeros((3, 2), np.int32)),
                         ("rope_delta", np.zeros(2, np.int32)), ("mm_spans", np.zeros((2, 1, 2), np.int32))):
        assert not runner._packed_supported(WorkerBatch(**base, **{field: value})), field


def test_kv_budget_leaves_the_forward_workspace():
    """The KV pool's budget on the card leaves MLA's decode gather and the
    vision tower's peak for ``VISION_BATCH`` images outside it."""
    from scratchpad_tpu_torch.executor.model_runner import kv_budget_bytes
    from scratchpad_tpu_torch.ops.attention.mla_backend import DECODE_GATHER_BYTES
    from scratchpad_tpu_torch.models.vision import attention_workspace_bytes

    GiB = 2**30
    assert kv_budget_bytes(70 * GiB, 80 * GiB, 0.85, 0) == int(80 * GiB * 0.85) - 10 * GiB
    assert kv_budget_bytes(70 * GiB, 80 * GiB, 0.85, 3 * GiB) == int(80 * GiB * 0.85) - 13 * GiB
    eng = Engine(ServerArgs(device="cpu", **dict(ARGS, max_total_tokens=256)),
                 model_config=ModelConfig(**model_kw("gemma3"), dtype="float32"))
    runner = eng.scheduler.runner
    P, heads = runner.model.vision.grid**2, runner.model.vision.heads
    ws = runner.forward_workspace_bytes()
    assert ws >= attention_workspace_bytes(runner.VISION_BATCH, heads, P, 4)
    # SigLIP at 896 px (Gemma 3): 16 heads over 4,096 patches, f32 scores of
    # 1.07 GB an image and layer
    assert attention_workspace_bytes(1, 16, 4096, 2) // (4 + 4 + 2) * 4 == 16 * 4096**2 * 4
    text = Engine(ServerArgs(device="cpu", preset="tiny-debug", **dict(ARGS, max_total_tokens=256)))
    assert text.scheduler.runner.forward_workspace_bytes() == 0
    from scratchpad_tpu_torch.config.model_config import ModelConfig as Cfg

    mla = Engine(ServerArgs(device="cpu", **dict(ARGS, max_total_tokens=256)), model_config=Cfg.from_hf_config({
        "architectures": ["DeepseekV2ForCausalLM"], "vocab_size": 512, "hidden_size": 64,
        "intermediate_size": 128, "num_hidden_layers": 2, "num_attention_heads": 4, "num_key_value_heads": 4,
        "kv_lora_rank": 32, "qk_nope_head_dim": 16, "qk_rope_head_dim": 8, "v_head_dim": 16,
        "n_routed_experts": 4, "num_experts_per_tok": 2, "moe_intermediate_size": 32,
        "first_k_dense_replace": 1}, dtype="float32"))
    assert mla.scheduler.runner.forward_workspace_bytes() == DECODE_GATHER_BYTES
