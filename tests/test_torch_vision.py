"""The vision models' towers and projectors in the port against the JAX
package and HF transformers, on the CPU in f32.

- From one seeded JAX parameter pytree (``params_from_jax``): the LLaVA
  (CLIP, layer -2, no class token, two-layer GELU projector), Gemma 3
  (SigLIP, average pool, (1 + w) RMS norm, projector) and Qwen2-VL (2-D
  rope, merger) ``encode_images`` against the JAX models', and Qwen2-VL's
  ``encode_video`` on an odd frame count (its tail repeats the last
  frame); 1e-5.
- From HF models built from their configs (``convert_hf_state``, both
  checkpoint nestings): the features against HF's ``get_image_features``
  (the Qwen2-VL tower on the HF processor's patch order), 3e-4 as the JAX
  tests hold theirs.
- ``compute_mrope`` for one image, two images and a video against HF's
  ``get_rope_index``, and ``apply_mrope`` against the JAX one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scratchpad_tpu.config.model_config import ModelConfig as JaxModelConfig
from scratchpad_tpu.models import common as jax_common
from scratchpad_tpu.models.registry import get_model_class as jax_model_class
from scratchpad_tpu_torch.config.model_config import ModelConfig
from scratchpad_tpu_torch.executor.weight_loader import params_from_jax
from scratchpad_tpu_torch.models.common import apply_mrope, mrope_channel_components
from scratchpad_tpu_torch.models.registry import get_model_class
import torch_threads  # noqa: F401  (one torch thread a test process)

TOL = dict(rtol=1e-5, atol=1e-5)
HF_TOL = dict(rtol=1e-3, atol=3e-4)

TEXT = dict(vocab_size=512, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, head_dim=16,
            max_position_embeddings=1024, rms_norm_eps=1e-5, rope_theta=10000.0,
            tie_word_embeddings=False)
LLAVA_IMG = 500
LLAVA_VISION = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=3,
                    num_attention_heads=4, image_size=24, patch_size=8, num_channels=3)
GEMMA_IMG, GEMMA_TOKENS = 500, 4
GEMMA_VISION = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                    num_attention_heads=4, image_size=28, patch_size=7, num_channels=3)
QWEN_IMG, QWEN_VSTART, QWEN_VEND, QWEN_VID = 501, 502, 503, 504
QWEN_VISION = dict(embed_dim=32, depth=2, num_heads=2, mlp_ratio=2, in_channels=3, patch_size=4,
                   spatial_merge_size=2, temporal_patch_size=2, hidden_size=64)
QWEN_IMAGE_SIZE = 16  # a 4 x 4 grid merged to 2 x 2 = 4 tokens


def model_kw(family: str) -> dict:
    """The tiny VLM's ``ModelConfig`` fields (both packages take them)."""
    if family == "llava":
        return dict(TEXT, architecture="LlavaForConditionalGeneration", multimodal=dict(
            vision_config=dict(LLAVA_VISION), image_token_index=LLAVA_IMG,
            vision_feature_layer=-2, vision_feature_select_strategy="default",
            projector_hidden_act="gelu"))
    if family == "gemma3":
        return dict(TEXT, architecture="Gemma3ForConditionalGeneration", rms_norm_eps=1e-6,
                    query_pre_attn_scalar=16, sliding_window=8, sliding_window_pattern=2,
                    tie_word_embeddings=True, multimodal=dict(
                        vision_config=dict(GEMMA_VISION), mm_tokens_per_image=GEMMA_TOKENS,
                        image_token_index=GEMMA_IMG))
    return dict(TEXT, architecture="Qwen2VLForConditionalGeneration",
                rope_scaling={"type": "mrope", "mrope_section": [2, 3, 3]}, multimodal=dict(
                    vision_config=dict(QWEN_VISION), image_token_id=QWEN_IMG,
                    video_token_id=QWEN_VID, vision_start_token_id=QWEN_VSTART,
                    image_size=QWEN_IMAGE_SIZE))


IMAGE_SIZE = {"llava": 24, "gemma3": 28, "qwen2vl": QWEN_IMAGE_SIZE}


def jax_and_port(family: str, seed: int = 0):
    """A JAX model's seeded init and the port model (CPU, f32) on it."""
    jcfg = JaxModelConfig(**model_kw(family), dtype="float32")
    jmodel = jax_model_class(jcfg.architecture)(jcfg)
    params = jmodel.init_params(jax.random.PRNGKey(seed), jnp.float32)
    params = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(seed)
    for tree in ("vision", "projector"):  # biases and norms off their init
        if tree in params:
            params[tree] = jax.tree.map(lambda a: a + 0.05 * rng.standard_normal(a.shape).astype(a.dtype)
                                        if a.ndim <= 2 and a.shape[-1] < 256 else a, params[tree])
    cfg = ModelConfig(**model_kw(family), dtype="float32")
    model = get_model_class(cfg.architecture)(cfg, torch.device("cpu"), torch.float32)
    model.load_state_dict(params_from_jax(params, cfg))
    return jmodel, params, model


def pixels(family: str, n: int, seed: int = 1) -> np.ndarray:
    S = IMAGE_SIZE[family]
    return np.random.default_rng(seed).standard_normal((n, 3, S, S)).astype(np.float32)


@pytest.mark.parametrize("family", ["llava", "gemma3", "qwen2vl"])
def test_encode_images_matches_jax(family):
    jmodel, params, model = jax_and_port(family)
    px = pixels(family, 3)
    want = np.asarray(jmodel.encode_images(jax.tree.map(jnp.asarray, params), jnp.asarray(px)))
    got = model.encode_images(torch.from_numpy(px)).detach().numpy()
    assert got.shape == want.shape == (3, model.num_image_tokens, TEXT["hidden_size"])
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("frames", [4, 3])
def test_encode_video_matches_jax(frames):
    jmodel, params, model = jax_and_port("qwen2vl")
    px = pixels("qwen2vl", frames, seed=frames)
    want = np.asarray(jmodel.encode_video(jax.tree.map(jnp.asarray, params), jnp.asarray(px)))
    got = model.encode_video(torch.from_numpy(px)).detach().numpy()
    assert got.shape == want.shape == (2, 4, TEXT["hidden_size"])
    np.testing.assert_allclose(got, want, **TOL)


def build_hf(family: str, seed: int = 0):
    """The HF model of the tiny config, f32, eager attention."""
    import transformers as tf

    torch.manual_seed(seed)
    text = {k: v for k, v in TEXT.items()}
    if family == "llava":
        cfg = tf.LlavaConfig(
            vision_config=tf.CLIPVisionConfig(**LLAVA_VISION).to_dict(),
            text_config=tf.LlamaConfig(**text, attn_implementation="eager").to_dict(),
            image_token_index=LLAVA_IMG, vision_feature_layer=-2,
            vision_feature_select_strategy="default", projector_hidden_act="gelu")
        return tf.LlavaForConditionalGeneration(cfg).eval()
    if family == "gemma3":
        cfg = tf.Gemma3Config(
            text_config=dict(text, rms_norm_eps=1e-6, query_pre_attn_scalar=16, sliding_window=8,
                             sliding_window_pattern=2, attn_implementation="eager"),
            vision_config=dict(GEMMA_VISION), mm_tokens_per_image=GEMMA_TOKENS,
            image_token_index=GEMMA_IMG, boi_token_index=498, eoi_token_index=499)
        return tf.Gemma3ForConditionalGeneration(cfg).eval()
    cfg = tf.Qwen2VLConfig(
        text_config=dict({k: v for k, v in text.items() if k != "head_dim"},
                         rope_scaling={"type": "mrope", "mrope_section": [2, 3, 3]}),
        vision_config=dict(QWEN_VISION), image_token_id=QWEN_IMG, video_token_id=QWEN_VID,
        vision_start_token_id=QWEN_VSTART, vision_end_token_id=QWEN_VEND)
    cfg.text_config._attn_implementation = "eager"
    cfg.vision_config._attn_implementation = "eager"
    return tf.Qwen2VLForConditionalGeneration(cfg).eval()


def hf_patches(px: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """[N, C, S, S] -> the HF Qwen2-VL processor's (pixel_values [N g g, C tp
    p p], grid_thw): each patch flattened (C, tp, ph, pw), merge-block order."""
    N, C, S, _ = px.shape
    p, m, tp = QWEN_VISION["patch_size"], QWEN_VISION["spatial_merge_size"], 2
    g = S // p
    x = px.reshape(N, C, g, p, g, p).transpose(0, 2, 4, 1, 3, 5)
    x = np.broadcast_to(x.reshape(N, g, g, C, 1, p * p), (N, g, g, C, tp, p * p))
    x = x.reshape(N, g // m, m, g // m, m, C * tp * p * p).transpose(0, 1, 3, 2, 4, 5)
    return np.ascontiguousarray(x.reshape(N * g * g, -1)), np.tile([[1, g, g]], (N, 1))


def _older_nesting(state: dict) -> dict:
    """The checkpoint names before transformers 4.52 (``language_model.model.*``,
    ``vision_tower.*`` at the top)."""
    out = {}
    for k, v in state.items():
        if k.startswith("model.language_model."):
            k = "language_model.model." + k[len("model.language_model."):]
        elif k.startswith("model."):
            k = k[len("model."):]
        elif k == "lm_head.weight":
            k = "language_model.lm_head.weight"
        out[k] = v
    return out


@pytest.mark.parametrize("family", ["llava", "gemma3", "qwen2vl"])
def test_features_match_hf(family):
    hf = build_hf(family)
    state = {k: v.detach().numpy() for k, v in hf.state_dict().items()}
    cfg = ModelConfig(**model_kw(family), dtype="float32")
    px = pixels(family, 2)
    with torch.no_grad():
        if family == "qwen2vl":
            flat, grid = hf_patches(px)
            theirs = hf.model.visual(torch.tensor(flat), grid_thw=torch.tensor(grid)).numpy()
            theirs = theirs.reshape(2, -1, TEXT["hidden_size"])
        else:
            theirs = hf.model.get_image_features(torch.tensor(px))
            theirs = torch.stack(list(theirs)).numpy() if isinstance(theirs, (list, tuple)) else theirs.numpy()
    nestings = [state] + ([_older_nesting(state)] if family != "qwen2vl" else [])
    for st in nestings:
        model = get_model_class(cfg.architecture)(cfg, torch.device("cpu"), torch.float32)
        model.load_state_dict(model.convert_hf_state(st, torch.float32))
        ours = model.encode_images(torch.from_numpy(px)).detach().numpy()
        np.testing.assert_allclose(ours, theirs, **HF_TOL)


@pytest.mark.parametrize("case", ["image", "two_images", "video"])
def test_compute_mrope_matches_hf(case):
    hf = build_hf("qwen2vl")
    cfg = ModelConfig(**model_kw("qwen2vl"), dtype="float32")
    model = get_model_class(cfg.architecture)(cfg, torch.device("cpu"), torch.float32)
    kw = {}
    if case == "image":
        ids = [3, QWEN_VSTART] + [QWEN_IMG] * 4 + [QWEN_VEND, 7, 9]
        spans, kw["image_grid_thw"] = [(2, 4)], [[1, 4, 4]]
    elif case == "two_images":
        ids = [3, QWEN_VSTART] + [QWEN_IMG] * 4 + [QWEN_VEND, 7, QWEN_VSTART] + [QWEN_IMG] * 4 + [QWEN_VEND, 9]
        spans, kw["image_grid_thw"] = [(2, 4), (9, 4)], [[1, 4, 4], [1, 4, 4]]
    else:
        ids = [3, QWEN_VSTART] + [QWEN_VID] * 8 + [QWEN_VEND, 7, 9]
        spans, kw["video_grid_thw"] = [(2, 8, 2)], [[2, 4, 4]]
    table, delta = model.compute_mrope(ids, spans)
    pos_hf, delta_hf = hf.model.get_rope_index(
        input_ids=torch.tensor([ids]), **{k: torch.tensor(v) for k, v in kw.items()})
    np.testing.assert_array_equal(table, pos_hf[:, 0, :].numpy())
    assert delta == int(delta_hf[0, 0])


def test_apply_mrope_matches_jax():
    rng = np.random.default_rng(3)
    D, T = 16, 9
    x = rng.standard_normal((T, 4, D)).astype(np.float32)
    mpos = rng.integers(0, 50, (3, T)).astype(np.int32)
    inv = (1.0 / 10000.0 ** (np.arange(0, D, 2) / D)).astype(np.float32)
    comp = mrope_channel_components([2, 3, 3], D)
    np.testing.assert_array_equal(comp, jax_common.mrope_channel_components([2, 3, 3], D))
    want = np.asarray(jax_common.apply_mrope(jnp.asarray(x), jnp.asarray(mpos), jnp.asarray(inv),
                                             jnp.asarray(comp)))
    got = apply_mrope(torch.from_numpy(x), torch.from_numpy(mpos), torch.from_numpy(inv),
                      torch.from_numpy(comp).long()).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_qwen2_patch_order_matches_hf_processor():
    """The tower's patches of a still image, in HF ``Qwen2VLImageProcessor``'s
    order and flattening (C, tp, ph, pw), on the processor's own
    normalised pixels."""
    from transformers.models.qwen2_vl.image_processing_qwen2_vl import Qwen2VLImageProcessor

    from scratchpad_tpu_torch.multimodal.image import CLIP_MEAN, CLIP_STD

    img = np.random.default_rng(0).integers(0, 255, (QWEN_IMAGE_SIZE, QWEN_IMAGE_SIZE, 3)).astype(np.uint8)
    proc = Qwen2VLImageProcessor(patch_size=QWEN_VISION["patch_size"], merge_size=QWEN_VISION["spatial_merge_size"],
                                 temporal_patch_size=QWEN_VISION["temporal_patch_size"], do_resize=False)
    theirs = proc(images=[img], return_tensors="np")["pixel_values"]
    x = ((img.astype(np.float32) / 255.0 - CLIP_MEAN) / CLIP_STD).transpose(2, 0, 1)[None]
    cfg = ModelConfig(**model_kw("qwen2vl"), dtype="float32")
    model = get_model_class(cfg.architecture)(cfg, torch.device("cpu"), torch.float32)
    ours = model.vision.patchify(torch.from_numpy(x))[0].numpy()
    np.testing.assert_allclose(ours, theirs, atol=1e-5)
