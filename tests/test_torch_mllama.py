"""Mllama (Llama 3.2 Vision) in the port against the JAX package and HF
transformers, on the CPU in f32, at tiny widths (a 6-layer decoder with
cross layers 1 and 4, a 3 + 2 layer tower of 32 px tiles, four tiles at
most over the eight aspect ratios of four tiles).

- ``select_tiling`` and ``preprocess_tiled`` against the JAX copies, bit
  for bit, on wide, tall, square, small and large images.
- From one seeded JAX pytree (``params_from_jax``; every gate opened, since
  the init's zero gates hide the image): the tower's features and the
  projected cross states against the JAX model's (one tile; 2 of 4 tiles at
  aspect ratio 2; 2 x 2), and the K/V each cross layer writes into a slot
  against the JAX ``_write_cross``; within ``TOL``.
- The engines on the same weights: prompts that start with the image, all
  tiles live, a text request and a chunked prefill give the JAX engine's
  greedy ids, the chosen logprobs (the extend's and the decode steps')
  within ``LP_TOL``.
- The two faults of the JAX Mllama, against HF
  ``MllamaForConditionalGeneration`` (its cross gates at 0.8) teacher-forced
  with the processor's ``cross_attention_mask``: an image of 2 live tiles of
  4 (the JAX decode windows attend the padding tiles) and text before the
  image (the JAX rows before it attend the image and run the cross MLP),
  with every tile live and with padding tiles.
  The port's logprobs stay within ``HF_TOL`` of HF's; the JAX engine's part
  from them by at least ten times that.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scratchpad_tpu.config import ServerArgs as JaxServerArgs
from scratchpad_tpu.config.model_config import ModelConfig as JaxModelConfig
from scratchpad_tpu.models.mllama import MllamaForCausalLM as JaxMllama
from scratchpad_tpu.multimodal import image as jax_image
from scratchpad_tpu.sampling.sampling_params import SamplingParams as JaxSamplingParams
from scratchpad_tpu.server.engine import Engine as JaxEngine
from scratchpad_tpu_torch.config import ServerArgs
from scratchpad_tpu_torch.config.model_config import ModelConfig
from scratchpad_tpu_torch.executor.weight_loader import params_from_jax
from scratchpad_tpu_torch.memory.kv_cache import KVCache
from scratchpad_tpu_torch.models.registry import get_model_class
from scratchpad_tpu_torch.multimodal import image as port_image
from scratchpad_tpu_torch.sampling.sampling_params import SamplingParams
from scratchpad_tpu_torch.server.engine import Engine
import torch_threads  # noqa: F401  (one torch thread a test process)

TOL = dict(rtol=1e-5, atol=1e-5)
LP_TOL = 1e-4
HF_TOL = 1e-4
GATE = 0.8

IMG = 500
TILE = 32
ASPECTS = [[1, 1], [1, 2], [1, 3], [1, 4], [2, 1], [2, 2], [3, 1], [4, 1]]
VISION = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=3, num_global_layers=2,
              attention_heads=2, image_size=TILE, patch_size=8, max_num_tiles=4,
              supported_aspect_ratios=ASPECTS, intermediate_layers_indices=[0, 2], vision_output_dim=96)
TEXT = dict(vocab_size=512, hidden_size=64, intermediate_size=128, num_hidden_layers=6,
            num_attention_heads=4, num_key_value_heads=2, rope_theta=10000.0,
            max_position_embeddings=512, rms_norm_eps=1e-5, tie_word_embeddings=False)
CROSS = [1, 4]
ARGS = dict(random_weights=True, dtype="float32", page_size=4, max_total_tokens=2048, cross_kv_slots=4)


def model_kw() -> dict:
    """The tiny Mllama's ``ModelConfig`` fields (both packages take them)."""
    return dict(TEXT, architecture="MllamaForConditionalGeneration", head_dim=16,
                cross_attention_layers=list(CROSS),
                multimodal=dict(vision_config=dict(VISION), image_token_index=IMG))


def opened(params: dict, seed: int = 0) -> dict:
    """The JAX pytree (numpy) with every gate of the tower and the cross
    layers drawn in [0.3, 0.9] and the norms and biases moved off their
    init by 0.05 N(0, 1)."""
    rng = np.random.default_rng(seed)

    def move(path, a):
        name = str(path[-1].key)
        if "gate" in name and a.shape[-1] == 1 or name in ("pos_gate", "pre_tile_gate", "post_tile_gate"):
            return rng.uniform(0.3, 0.9, a.shape).astype(a.dtype)
        if "norm" in name or name.startswith("ln") or name.endswith("_b") or name == "b":
            return a + 0.05 * rng.standard_normal(a.shape).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(move, params)


def tiles(n_live: int, seed: int) -> np.ndarray:
    out = np.zeros((4, 3, TILE, TILE), np.float32)
    out[:n_live] = np.random.default_rng(seed).standard_normal((n_live, 3, TILE, TILE)) * 0.5
    return out


@pytest.fixture(scope="module")
def models():
    jcfg = JaxModelConfig(**model_kw(), dtype="float32")
    jmodel = JaxMllama(jcfg)
    params = opened(jax.tree.map(np.asarray, jmodel.init_params(jax.random.PRNGKey(0), jnp.float32)))
    cfg = ModelConfig(**model_kw(), dtype="float32")
    model = get_model_class(cfg.architecture)(cfg, torch.device("cpu"), torch.float32)
    model.load_state_dict(params_from_jax(params, cfg))
    return jmodel, params, model


# ---------------------------------------------------------------- tiling


@pytest.mark.parametrize("w,h", [(100, 40), (40, 100), (100, 100), (30, 30), (130, 33), (33, 130), (64, 32)])
def test_tiles_match_jax_bit_for_bit(w, h):
    from PIL import Image

    sup = [tuple(a) for a in ASPECTS]
    assert port_image.select_tiling(w, h, TILE, sup) == jax_image.select_tiling(w, h, TILE, sup)
    arr = np.random.default_rng(w * h).integers(0, 255, (h, w, 3), dtype=np.uint8)
    img = Image.fromarray(arr, "RGB")
    got, want = port_image.preprocess_tiled(img, TILE, sup, 4), jax_image.preprocess_tiled(img, TILE, sup, 4)
    assert got[1:] == want[1:]
    np.testing.assert_array_equal(got[0], want[0])


# ------------------------------------------------------ tower and states


@pytest.mark.parametrize("n_live,ar_id", [(1, None), (2, 2), (4, 6)], ids=["one-tile", "1x2-of-4", "2x2"])
def test_tower_and_cross_states_match_jax(models, n_live, ar_id):
    """The tower's features [N, T x patches, 3 Hv] and the projected cross
    states [N, T x patches, H]: one tile ([N, C, S, S], the JAX legacy
    form), 2 live tiles of 4 (their padding tiles masked in pairs) and a
    2 x 2 canvas."""
    jmodel, params, model = models
    jp = jax.tree.map(jnp.asarray, params)
    if ar_id is None:
        px = np.random.default_rng(3).standard_normal((2, 3, TILE, TILE)).astype(np.float32)
        jfeat = jmodel.vision(jp["vision"], jnp.asarray(px))
        jstates = jmodel.encode_images(jp, jnp.asarray(px))
        tpx, ar, nt = torch.from_numpy(px)[:, None], torch.ones(2, dtype=torch.long), torch.ones(2, dtype=torch.long)
    else:
        px = np.stack([tiles(n_live, 4), tiles(n_live, 5)])
        ar, nt = np.array([ar_id, ar_id]), np.array([n_live, n_live])
        jfeat = jmodel.vision(jp["vision"], jnp.asarray(px), jnp.asarray(ar), jnp.asarray(nt))
        jstates = jmodel.encode_images(jp, jnp.asarray(px), jnp.asarray(ar), jnp.asarray(nt))
        tpx, ar, nt = torch.from_numpy(px), torch.from_numpy(ar), torch.from_numpy(nt)
    with torch.no_grad():
        feat = model.vision(tpx, ar, nt).numpy()
        states = model.encode_images(tpx, ar, nt).numpy()
    P = tpx.shape[1] * model.vision.num_patches
    assert feat.shape == (2, P, 96) and states.shape == (2, P, TEXT["hidden_size"])
    np.testing.assert_allclose(feat, np.asarray(jfeat), **TOL)
    np.testing.assert_allclose(states, np.asarray(jstates), **TOL)


def test_cross_kv_written_as_jax(models):
    """Each cross layer's K (``k_norm`` on it) and V of two images, written
    side by side a head into slots 2 and 1 over stale values, the second
    image's states half the slot's rows (the JAX side gets them
    zero-padded): the JAX ``_write_cross``'s buffer, slot for slot."""
    jmodel, params, model = models
    S, H = model.cross_len, TEXT["hidden_size"]
    states = np.random.default_rng(9).standard_normal((2, S, H)).astype(np.float32)
    states[1, S // 2 :] = 0
    shape = (4, len(CROSS), S, 2 * TEXT["num_key_value_heads"], 16)
    jbuf = jmodel._write_cross(jax.tree.map(jnp.asarray, params), jnp.zeros(shape, jnp.float32),
                               types.SimpleNamespace(cross_states=jnp.asarray(states),
                                                     cross_slots=jnp.array([2, 1])))
    kv = KVCache(k=torch.zeros(1), v=None, cross=torch.zeros(shape))
    kv.cross[1:3] = 7.0  # an earlier request's K/V
    with torch.no_grad():
        model.write_cross(kv, 2, torch.from_numpy(states[0]))
        model.write_cross(kv, 1, torch.from_numpy(states[1, : S // 2]))
    np.testing.assert_allclose(kv.cross.numpy(), np.asarray(jbuf), **TOL)


# ---------------------------------------------------------------- engines


@pytest.fixture(scope="module")
def engines():
    jeng = JaxEngine(JaxServerArgs(**ARGS, chunked_prefill_size=6, warmup_capture=False),
                     model_config=JaxModelConfig(**model_kw(), dtype="float32"))
    runner = jeng.scheduler.runner
    params = opened(jax.tree.map(np.asarray, runner.params), seed=1)
    runner.params = jax.tree.map(jnp.asarray, params)
    eng = Engine(ServerArgs(device="cpu", **ARGS, chunked_prefill_size=6),
                 model_config=ModelConfig(**model_kw(), dtype="float32"))
    eng.scheduler.runner.model.load_state_dict(params_from_jax(params, eng.model_config))
    return jeng, eng


def test_engine_matches_jax(engines):
    """Image-first prompts with every tile live (a 2 x 2 and a 4 x 1
    canvas), a text request and a 13-token prompt that prefills in chunks
    of 6 (its slot written at the first chunk, read at the later ones), in
    one batch; each answer's greedy ids and chosen logprobs as the JAX
    engine's. (An image with padding tiles, a one-tile image among them,
    parts from the JAX decode: ``test_port_follows_hf_where_jax_parts``.)"""
    jeng, eng = engines
    prompts = [[IMG, 7, 11, 13, 17, 19], [IMG, 5, 6], [4, 10, 12, 14],
               [IMG] + np.random.default_rng(12).integers(1, 400, 12).tolist()]
    images = [(tiles(4, 7), 6, 4), (tiles(4, 11), 8, 4), None, (tiles(4, 8), 6, 4)]
    n = 8
    outs = eng.generate(input_ids=prompts, image_data=images, return_logprob=True,
                        sampling_params=[SamplingParams(temperature=0.0, max_new_tokens=n)] * 4)
    jouts = jeng.generate(input_ids=prompts, image_data=images, return_logprob=True,
                          sampling_params=[JaxSamplingParams(temperature=0.0, max_new_tokens=n)] * 4)
    for o, j in zip(outs, jouts):
        assert len(o.output_ids) == n and o.output_ids == j.output_ids
        np.testing.assert_allclose(o.output_token_logprobs, j.output_token_logprobs, rtol=0, atol=LP_TOL)
    # the image moves the answer: the text request's prompt with an image
    alone = eng.generate(input_ids=[IMG, 10, 12, 14], image_data=(tiles(4, 7), 6, 4), return_logprob=True,
                         sampling_params=SamplingParams(temperature=0.0, max_new_tokens=n))
    assert alone.output_token_logprobs[0] != outs[2].output_token_logprobs[0]
    eng.scheduler.check_memory_leak()


def test_the_radix_cache_keeps_images_apart_where_jax_shares(engines):
    """A text request behind an image request's header (two pages): every
    row of the image request attends its image in the cross layers, the
    header's too, so the port reuses none of its pages and answers as on an
    empty cache, within ``LP_TOL`` of the JAX engine on an empty cache. The
    JAX radix cache keys those rows by their text alone: it reuses them,
    and its answer parts from its own on an empty cache by at least ten
    times ``LP_TOL``."""
    jeng, eng = engines
    header = [7, 11, 13, 17, 19, 23, 29, 31]
    image_req, text_req = header + [IMG, 37, 41], header + [43, 47, 53]
    image = (tiles(4, 13), 6, 4)
    sp = lambda cls: cls(temperature=0.0, max_new_tokens=4, ignore_eos=True)
    answers = {}
    for name, e, cls in (("port", eng, SamplingParams), ("jax", jeng, JaxSamplingParams)):
        e.flush_cache()
        e.generate(input_ids=image_req, image_data=image, sampling_params=sp(cls))
        behind = e.generate(input_ids=text_req, sampling_params=sp(cls), return_logprob=True)
        e.flush_cache()
        alone = e.generate(input_ids=text_req, sampling_params=sp(cls), return_logprob=True)
        answers[name] = behind, alone
    (p_behind, p_alone), (j_behind, j_alone) = answers["port"], answers["jax"]
    assert p_behind.cached_tokens == 0 and j_behind.cached_tokens == len(header)
    np.testing.assert_allclose(p_behind.output_token_logprobs, p_alone.output_token_logprobs, rtol=0, atol=1e-6)
    np.testing.assert_allclose(p_behind.output_token_logprobs, j_alone.output_token_logprobs, rtol=0, atol=LP_TOL)
    gap = abs(j_behind.output_token_logprobs[0] - j_alone.output_token_logprobs[0])
    assert gap >= 10 * LP_TOL, gap
    eng.scheduler.check_memory_leak()


# ------------------------------------------------------- faults against HF


def build_hf(seed: int = 5):
    """HF ``MllamaForConditionalGeneration`` of the tiny config (f32, eager),
    every gate at ``GATE``: HF's init leaves them at 0, where tanh(0) takes
    every effect of the image away."""
    from transformers import MllamaConfig, MllamaForConditionalGeneration

    text = dict(TEXT, cross_attention_layers=list(CROSS), pad_token_id=0, bos_token_id=1,
                eos_token_id=2, rope_scaling={"rope_type": "default"})
    cfg = MllamaConfig(vision_config=dict(VISION), text_config=text, image_token_index=IMG)
    cfg.text_config._attn_implementation = "eager"
    cfg.vision_config._attn_implementation = "eager"
    torch.manual_seed(seed)
    hf = MllamaForConditionalGeneration(cfg).eval().to(torch.float32)
    with torch.no_grad():
        for name, p in hf.named_parameters():
            if name.endswith(("gate", "gate_attn", "gate_ffn")):
                p.fill_(GATE)
    return hf


def hf_logprobs(hf, prompt, out_ids, px, ar_id, n_tiles) -> np.ndarray:
    """HF's logprobs of ``out_ids`` after ``prompt``, teacher-forced in one
    forward, with the processor's cross mask (each row from the image token
    on attends the live tiles; the rows before it, none) over every row, as
    ``generate`` extends it."""
    from transformers.models.mllama.processing_mllama import (
        convert_sparse_cross_attention_mask_to_dense,
        get_cross_attention_token_mask,
    )

    ids = prompt + out_ids[:-1]
    cam = convert_sparse_cross_attention_mask_to_dense(
        [get_cross_attention_token_mask(ids, IMG)], [[n_tiles]], 4, len(ids))
    with torch.no_grad():
        logits = hf(input_ids=torch.tensor([ids]), pixel_values=torch.from_numpy(px)[None, None],
                    aspect_ratio_ids=torch.tensor([[ar_id]]),
                    aspect_ratio_mask=(torch.arange(4) < n_tiles).long()[None, None],
                    cross_attention_mask=torch.from_numpy(cam)).logits[0]
    lp = torch.log_softmax(logits.double(), dim=-1)
    return np.array([float(lp[len(prompt) - 1 + i, t]) for i, t in enumerate(out_ids)])


@pytest.fixture(scope="module")
def hf_engines():
    hf = build_hf()
    state = {k: v.detach().numpy() for k, v in hf.state_dict().items()}
    jeng = JaxEngine(JaxServerArgs(**ARGS, warmup_capture=False),
                     model_config=JaxModelConfig(**model_kw(), dtype="float32"))
    assert jeng.scheduler.runner.update_weights(state)[0]
    eng = Engine(ServerArgs(device="cpu", **ARGS), model_config=ModelConfig(**model_kw(), dtype="float32"))
    assert eng.scheduler.runner.update_weights(state)[0]
    return hf, jeng, eng


@pytest.mark.parametrize(
    "prompt,n_live,ar_id,n_new",
    [([IMG, 7, 11, 13, 17, 19], 2, 2, 24), ([7, 11, IMG, 13, 17, 19], 4, 6, 8),
     ([7, 11, IMG, 13, 17, 19], 2, 2, 8)],
    ids=["padding-tiles-in-decode", "text-before-the-image", "text-before-a-padded-image"],
)
def test_port_follows_hf_where_jax_parts(hf_engines, prompt, n_live, ar_id, n_new):
    """Each engine's greedy answer, its logprobs against HF's on the same
    ids: the port within ``HF_TOL``, the JAX engine at least ten times
    that away. With padding tiles, the rows before the image attend them
    too (their cross mask is empty, so HF masks nothing), the rows after
    it only the live tiles."""
    hf, jeng, eng = hf_engines
    px = tiles(n_live, 6)
    image = (px, ar_id, n_live)
    p = eng.generate(input_ids=prompt, image_data=image, return_logprob=True,
                     sampling_params=SamplingParams(temperature=0.0, max_new_tokens=n_new, ignore_eos=True))
    j = jeng.generate(input_ids=prompt, image_data=image, return_logprob=True,
                      sampling_params=JaxSamplingParams(temperature=0.0, max_new_tokens=n_new, ignore_eos=True))
    port_gap = np.abs(p.output_token_logprobs - hf_logprobs(hf, prompt, p.output_ids, px, ar_id, n_live)).max()
    jax_gap = np.abs(j.output_token_logprobs - hf_logprobs(hf, prompt, j.output_ids, px, ar_id, n_live)).max()
    assert port_gap <= HF_TOL, port_gap
    assert jax_gap >= 10 * HF_TOL, jax_gap
    eng.scheduler.check_memory_leak()
