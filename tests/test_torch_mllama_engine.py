"""The port's Mllama engine and HTTP server on the CPU in f32, at the tiny
widths of ``tests/test_torch_mllama.py`` (random weights, every gate
opened):

- a mixed batch (a tiled image with padding tiles, text only, text before
  the image, a one-tile image) answers as each request does alone;
- with ``cross_kv_slots=2`` a third image request waits for a slot, takes
  the one the first request to finish frees, and answers as it does alone;
- two images behind one prompt never alias in the radix cache, while the
  same image again reuses the prompt past it;
- the refusals: speculative decoding, quantization, 8-bit KV, toppings, two
  images or none for one placeholder;
- Llama-3.2-11B-Vision's published config (``chip_smoke.py``'s literal)
  through ``ModelConfig.from_hf_config``: its nested text and vision
  configs and cross layers; built on the meta device, the port's model has
  HF's parameter count, 10,670,220,835, 32 self layers and 6,404 cross rows;
- the KV budget leaves the cross buffer, the cross layer's scores and the
  tower's workspace out of the pool (at Llama-3.2-11B-Vision's widths the
  buffer of 16 slots and the scratch slot is 3.32 GiB in bf16);
- a chat request with an image part through the port's standard-library
  client (``utils/client.post_json``) under the ``llama_3_vision``
  template answers what ``Engine.generate`` answers; two images in one chat
  answer 400.

Each engine ends with ``check_memory_leak`` (pages, request slots, cross
slots).
"""

import base64
import io
import urllib.error

import numpy as np
import pytest
import torch

from scratchpad_tpu_torch.config import ServerArgs
from scratchpad_tpu_torch.config.model_config import ModelConfig
from scratchpad_tpu_torch.memory.kv_cache import KVCacheConfig
from scratchpad_tpu_torch.models.mllama import MllamaVisionTower, cross_workspace_bytes
from scratchpad_tpu_torch.sampling.sampling_params import SamplingParams
from scratchpad_tpu_torch.server.engine import Engine
from scratchpad_tpu_torch.server.http_server import ServerApp, ServerThread
from scratchpad_tpu_torch.server.openai_api.conversation import get_template
from scratchpad_tpu_torch.utils.client import post_json
from test_torch_mllama import IMG, TILE, model_kw, tiles
from test_torch_server import CharTokenizer, _free_port
import torch_threads  # noqa: F401  (one torch thread a test process)

ARGS = dict(random_weights=True, dtype="float32", page_size=4, max_total_tokens=1024)
N_NEW = 6


def make_engine(tokenizer=None, **kw) -> Engine:
    eng = Engine(ServerArgs(device="cpu", **dict(ARGS, **kw)), tokenizer=tokenizer,
                 model_config=ModelConfig(**model_kw(), dtype="float32"))
    with torch.no_grad():
        for name, p in eng.scheduler.runner.model.named_parameters():
            if "gate" in name.split(".")[-1] and p.shape[-1] == 1:
                p.fill_(0.7)
    return eng


def greedy(n=N_NEW):
    return SamplingParams(temperature=0.0, max_new_tokens=n, ignore_eos=True)


ONE_TILE = np.random.default_rng(21).standard_normal((3, TILE, TILE)).astype(np.float32)
REQUESTS = [([IMG, 7, 11, 13], (tiles(2, 1), 2, 2)), ([3, 4, 5, 6, 8], None),
            ([9, 10, 12, IMG, 14, 15], (tiles(4, 2), 6, 4)), ([IMG, 20, 21], ONE_TILE)]


def test_mixed_batch_answers_as_alone():
    eng = make_engine()
    outs = eng.generate(input_ids=[r[0] for r in REQUESTS], image_data=[r[1] for r in REQUESTS],
                        sampling_params=[greedy()] * len(REQUESTS), return_logprob=True)
    for (prompt, image), o in zip(REQUESTS, outs):
        eng.flush_cache()
        alone = eng.generate(input_ids=prompt, image_data=image, sampling_params=greedy(), return_logprob=True)
        assert o.output_ids == alone.output_ids
        np.testing.assert_allclose(o.output_token_logprobs, alone.output_token_logprobs, rtol=0, atol=1e-5)
    eng.scheduler.check_memory_leak()


def test_third_image_request_waits_for_a_slot():
    eng = make_engine(cross_kv_slots=2)
    images = [(tiles(2, 3), 2, 2), (tiles(4, 4), 6, 4), (tiles(3, 5), 7, 3)]
    prompts = [[IMG, 7, 8], [IMG, 9, 10, 11], [IMG, 12]]
    lens = [2, 8, 4]
    sched = eng.scheduler
    reqs = [eng._make_req(None, p, greedy(n), image_data=im) for p, im, n in zip(prompts, images, lens)]
    for r in reqs:
        sched.add_request(r)
    sched.step()
    assert sorted(r.cross_slot for r in reqs[:2]) == [1, 2] and reqs[2].cross_slot is None
    assert reqs[2] in sched.waiting and not sched.cross_slot_free
    third_slot = None
    while sched.has_work():
        sched.step()
        if reqs[2].cross_slot is not None and third_slot is None:
            assert reqs[0].finished()
            third_slot = reqs[2].cross_slot
    assert third_slot == 1  # the slot the first request freed
    for r, p, im, n in zip(reqs, prompts, images, lens):
        eng.flush_cache()
        assert r.output_ids == eng.generate(input_ids=p, image_data=im, sampling_params=greedy(n)).output_ids
    assert sorted(sched.cross_slot_free) == [1, 2]
    sched.check_memory_leak()


TEXT_FIRST = list(range(30, 42))  # 12 tokens, three pages, before the image
IMAGE_A, IMAGE_B = (tiles(4, 8), 6, 4), (tiles(4, 9), 6, 4)


@pytest.mark.parametrize("first,second", [
    (IMAGE_A, IMAGE_B),  # another image behind the same prompt
    (IMAGE_A, None),  # a text request behind the image request's header
    (None, IMAGE_A),  # an image request behind a text request's header
])
def test_images_never_alias_in_the_radix_cache(first, second):
    """Every row of an image request attends its image in the cross layers,
    the text before the placeholder too (HF), so the second request reuses
    no page of the first and answers as it does on an empty cache; the
    first request's image again reuses its prompt past the image."""
    eng = make_engine()

    def serve(image):
        prompt = TEXT_FIRST + ([IMG] if image is not None else [49]) + [50, 51, 52, 53, 54, 55, 56, 57]
        return eng.generate(input_ids=prompt, image_data=image, sampling_params=greedy(), return_logprob=True)

    a = serve(first)
    b = serve(second)
    assert b.cached_tokens == 0
    eng.flush_cache()
    alone = serve(second)
    assert b.output_ids == alone.output_ids
    np.testing.assert_allclose(b.output_token_logprobs, alone.output_token_logprobs, rtol=0, atol=1e-5)
    eng.flush_cache()
    serve(first)
    again = serve(first)
    assert again.cached_tokens > len(TEXT_FIRST) and again.output_ids == a.output_ids
    eng.scheduler.check_memory_leak()


def test_emptied_image_trees_are_dropped():
    """A tree of an image lives while it holds pages: eviction that empties
    it drops it, the adapter's tree stays, and a flush drops every image's."""
    eng = make_engine()
    sched = eng.scheduler
    group = sched.tree_cache
    eng.generate(input_ids=TEXT_FIRST + [IMG, 50, 51, 52], image_data=IMAGE_A, sampling_params=greedy())
    eng.generate(input_ids=TEXT_FIRST + [49, 50, 51, 52], sampling_params=greedy())
    image_trees = [k for k in group._trees if isinstance(k, tuple)]
    assert len(image_trees) == 1 and group.get(image_trees[0]).total_pages > 0
    group.evict(group.evictable_pages, sched.allocator.free)
    assert list(group._trees) == [0]
    eng.generate(input_ids=TEXT_FIRST + [IMG, 50], image_data=IMAGE_B, sampling_params=greedy())
    assert len(group._trees) == 2
    eng.flush_cache()
    assert list(group._trees) == [0]
    sched.check_memory_leak()


@pytest.mark.parametrize(
    "kw,error,match",
    [(dict(speculative_algorithm="ngram"), ValueError, "speculative decoding is not supported"),
     (dict(quantization="w4a8"), NotImplementedError, "quantization"),
     (dict(kv_cache_dtype="int8"), NotImplementedError, "8-bit KV"),
     (dict(kv_cache_dtype="fp8"), NotImplementedError, "8-bit KV"),
     ("toppings", NotImplementedError, "toppings"),
     ("two images", ValueError, "one image a request"),
     ("no placeholder", ValueError, "0 image tokens")],
    ids=["spec", "w4a8", "int8-kv", "fp8-kv", "toppings", "two-images", "no-placeholder"],
)
def test_refusals(kw, error, match):
    with pytest.raises(error, match=match):
        if kw == "toppings":
            make_engine().register_topping("a", state={})
        elif kw == "two images":
            make_engine().generate(input_ids=[IMG, 1], image_data=np.stack([ONE_TILE, ONE_TILE]))
        elif kw == "no placeholder":
            make_engine().generate(input_ids=[1, 2], image_data=ONE_TILE)
        else:
            make_engine(**kw)


def test_published_config_builds_hf_parameter_count():
    import chip_smoke
    from transformers import MllamaConfig, MllamaForConditionalGeneration

    from scratchpad_tpu_torch.models.mllama import MllamaForCausalLM

    full = chip_smoke.LLAMA32_11B_VISION
    cfg = ModelConfig.from_hf_config(full)
    assert cfg.architecture == "MllamaForConditionalGeneration" and cfg.num_hidden_layers == 40
    assert cfg.cross_attention_layers == [3, 8, 13, 18, 23, 28, 33, 38] and cfg.head_dim == 128
    assert cfg.multimodal["image_token_index"] == 128256 and cfg.multimodal["vision_config"]["max_num_tiles"] == 4
    model = MllamaForCausalLM(cfg, torch.device("meta"), torch.bfloat16)
    assert model.num_kv_layers == 32 and model.cross_len == 4 * 1601 and model.vision.out_dim == 7680
    assert model.segments == [(3, 0)] + [(4, i) for i in range(1, 8)] + [(1, None)]
    hf_cfg = MllamaConfig(text_config=dict(full["text_config"]), vision_config=dict(full["vision_config"]),
                          image_token_index=full["image_token_index"])
    with torch.device("meta"):
        hf = MllamaForConditionalGeneration(hf_cfg)
    count = sum(p.numel() for p in model.parameters())
    assert count == sum(p.numel() for p in hf.parameters()) == 10_670_220_835


def test_kv_budget_leaves_the_cross_buffer():
    eng = make_engine()
    runner = eng.scheduler.runner
    model, kvc = runner.model, runner.kv_config
    assert kvc.num_layers == 4 and kvc.cross_layers == 2 and kvc.cross_slots == 17
    assert runner.kv_cache.cross.shape == (17, 2, 4 * 17, 4, 16)
    assert runner.kv_bytes_per_token() == 2 * 4 * 2 * 16 * 4  # self layers only
    want = kvc.cross_bytes() + cross_workspace_bytes(model.cfg, model.cross_len) + model.vision.workspace_bytes(1)
    assert kvc.cross_bytes() == runner.kv_cache.cross.numel() * 4
    assert runner.forward_workspace_bytes() == want
    # Llama-3.2-11B-Vision: 8 cross layers of 8 kv heads at D 128, 4 tiles of
    # 1,601 patches, 16 slots and the scratch one, bf16
    big = KVCacheConfig(32, 0, 16, 8, 128, torch.bfloat16, cross_layers=8, cross_len=4 * 1601, cross_slots=17)
    assert big.cross_bytes() == 17 * 8 * 6404 * 16 * 128 * 2
    assert round(big.cross_bytes() / 2**30, 2) == 3.32
    tower = MllamaVisionTower(dict(hidden_size=1280, attention_heads=16, num_hidden_layers=32,
                                   num_global_layers=8, image_size=560, patch_size=14, max_num_tiles=4,
                                   intermediate_size=5120, intermediate_layers_indices=[3, 7, 15, 23, 30]),
                              "meta", torch.bfloat16)
    L = 4 * 1608
    assert tower.workspace_bytes(1) == 4 * L * L * (4 + 4 + 2) + L * L * 4 + L * 5120 * 4
    eng.scheduler.check_memory_leak()


def png(w=70, h=30) -> bytes:
    from PIL import Image

    arr = np.random.default_rng(w).integers(0, 255, (h, w, 3), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr, "RGB").save(buf, format="PNG")
    return buf.getvalue()


def test_chat_with_a_tiled_image():
    from scratchpad_tpu_torch.multimodal import decode_image

    port = _free_port()
    eng = make_engine(CharTokenizer(), port=port, chat_template="llama_3_vision", mm_image_token=chr(IMG - 1))
    srv = ServerThread(ServerApp(eng, eng.args))
    try:
        url = f"http://127.0.0.1:{port}/v1/chat/completions"
        part = {"type": "image_url", "image_url": {"url": "data:image/png;base64," + base64.b64encode(png()).decode()}}
        body = {"model": "m", "max_tokens": N_NEW, "temperature": 0.0, "ignore_eos": True,
                "messages": [{"role": "user", "content": [part, {"type": "text", "text": "what is it?"}]}]}
        out = post_json(url, body)
        tiled = eng.preprocess_image(decode_image(png()))
        assert isinstance(tiled, tuple) and tiled[1:] == (3, 3)  # 70 x 30: one row of three tiles, [1, 3]
        prompt = get_template("llama_3_vision").render([{"role": "user", "content": chr(IMG - 1) + "what is it?"}])
        ids = CharTokenizer().encode(prompt)
        assert ids.index(IMG) > 0  # the template's header comes before the image
        want = eng.generate(input_ids=ids, image_data=tiled, sampling_params=greedy())
        assert out["choices"][0]["message"]["content"] == want.text
        two = dict(body, messages=[{"role": "user", "content": [part, part]}])
        with pytest.raises(urllib.error.HTTPError) as e:
            post_json(url, two)
        assert e.value.code == 400 and b"one tiled image" in e.value.read()
    finally:
        srv.stop()
    eng.scheduler.check_memory_leak()
