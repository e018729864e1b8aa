"""The memory extras in the port against the JAX package, on the CPU in f32:
the host KV tier, a KV-pool resize, a weight update and parameter offload.

Each JAX case (``tests/test_memory.py``'s host-tier cases,
``tests/test_engine_extras.py``'s update, resize and offload cases) runs
on a JAX engine and a port engine that serve the same weights; the greedy
ids are equal and the chosen logprobs agree within ``LP_TOL``; the
host-tier promotion so on pools of the model dtype, int8 and fp8. Beside
them: pages gathered and scattered back bit for bit (bf16-layout f32,
int8 and fp8 pools, a latent pool), the tier on an int8 pool, an update
through HF names and through the model's own names on a W4A8 engine, and
the HTTP routes ``/memory_pool`` and ``/update_weights``.
"""

import json
import os
import socket
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file

from scratchpad_tpu.config import ServerArgs as JaxServerArgs
from scratchpad_tpu.sampling.sampling_params import SamplingParams as JaxSamplingParams
from scratchpad_tpu.server.engine import Engine as JaxEngine
from scratchpad_tpu_torch.config import ServerArgs
from scratchpad_tpu_torch.executor.weight_loader import params_from_jax
from scratchpad_tpu_torch.models.llama import LlamaForCausalLM
from scratchpad_tpu_torch.sampling.sampling_params import SamplingParams
from scratchpad_tpu_torch.server.engine import Engine
import torch_threads  # noqa: F401  (one torch thread a test process)

ARGS = dict(preset="tiny-debug", random_weights=True, dtype="float32", page_size=4)
LP_TOL = 1e-4
# fp8 KV: at position 44 of the second evicting prompt one layer-0 K lies
# 2.4e-5 above the midpoint 29 of the e4m3 codes 28 and 30 in units of its
# scale (float64: 29.000024); the JAX engine's f32 K rounds it to 30, the
# port's to 28 (its K under 8.3e-7 below the exact one), and the layer-1 codes and the
# logprobs (by 1.2e-3) follow. One code apart, neither side at fault: the
# ids stay equal, the logprobs within 5e-3, and the port's promoted pages
# give its own first answer exactly.
FP8_LP_TOL = 5e-3
GREEDY = dict(temperature=0.0, ignore_eos=True)


def make_pair(**kw):
    kw = {"max_total_tokens": 2048, **kw}
    jeng = JaxEngine(JaxServerArgs(**ARGS, **kw))
    eng = Engine(ServerArgs(device="cpu", **ARGS, **kw))
    load(eng, jeng)
    return jeng, eng


def load(eng, jeng):
    """Serve ``jeng``'s weights in ``eng`` (its host layers under offload)."""
    params = params_from_jax(jax.tree.map(np.asarray, jeng.scheduler.runner.params), eng.model_config)
    runner = eng.scheduler.runner
    (runner.param_offload or runner.model).load_state_dict(params)


def gen_both(jeng, eng, prompt, lp_tol=LP_TOL, **sp):
    j = jeng.generate(input_ids=prompt, sampling_params=JaxSamplingParams(**sp), return_logprob=True)
    p = eng.generate(input_ids=prompt, sampling_params=SamplingParams(**sp), return_logprob=True)
    assert p.output_ids == j.output_ids
    np.testing.assert_allclose(p.output_token_logprobs, j.output_token_logprobs, atol=lp_tol, rtol=0)
    return j, p


def prompt(n, seed):
    return np.random.default_rng(seed).integers(1, 500, n).tolist()


# ------------------------------------------------------------- host KV tier


def _fill_and_return(jeng, eng, sp, pa, lp_tol=LP_TOL):
    first = gen_both(jeng, eng, pa, lp_tol, **sp)[1]
    for seed in range(3):  # evict pa's pages with other long prompts
        gen_both(jeng, eng, prompt(96, 10 + seed), lp_tol, **sp)
    tier = eng.scheduler.host_tier
    assert tier.stored_pages > 0
    again = gen_both(jeng, eng, pa, lp_tol, **sp)[1]
    assert tier.restored_pages > 0 and again.cached_tokens > 0
    assert again.output_ids == first.output_ids
    assert jeng.scheduler.host_tier.restored_pages == tier.restored_pages
    eng.scheduler.check_memory_leak()
    return first


@pytest.mark.parametrize("kv", ["float32", "int8", "fp8"])
def test_evicted_prefix_promotes_back(kv):
    """Pages the radix cache evicts go to the host tier and come back on a
    prefix hit, on a pool of the model dtype and on int8 and fp8 pools
    (codes and scales), each beside the JAX engine at the same setting."""
    jeng, eng = make_pair(max_total_tokens=256, host_kv_cache_tokens=4096,  # 64 pages: they evict
                          kv_cache_dtype="auto" if kv == "float32" else kv)
    assert eng.scheduler.runner.kv_cache.quantized == (kv != "float32")
    _fill_and_return(jeng, eng, dict(max_new_tokens=4, **GREEDY), prompt(96, 0),
                     FP8_LP_TOL if kv == "fp8" else LP_TOL)


def test_disabled_tier_unchanged():
    jeng, eng = make_pair(max_total_tokens=256)
    assert eng.scheduler.host_tier is None
    out = gen_both(jeng, eng, list(range(1, 40)), max_new_tokens=4, **GREEDY)[1]
    assert len(out.output_ids) == 4
    eng.scheduler.check_memory_leak()


def test_tier_with_pipelined_windows():
    """The tier beside depth-2 pipelined windows: eviction and promotion may
    fall between a window's dispatch and its fetch; the tokens stay those
    of the engine without the tier."""
    jeng, eng = make_pair(max_total_tokens=256, host_kv_cache_tokens=4096, enable_overlap=True,
                          decode_pipeline_depth=2)
    first = _fill_and_return(jeng, eng, dict(max_new_tokens=6, **GREEDY), prompt(96, 0))
    _, ref = make_pair(max_total_tokens=256)
    assert ref.generate(input_ids=prompt(96, 0),
                        sampling_params=SamplingParams(max_new_tokens=6, **GREEDY)).output_ids == first.output_ids


@pytest.mark.parametrize("kv", ["float32", "int8", "fp8"])
def test_gather_scatter_pages_bit_for_bit(kv):
    """Pages gathered from the pool and scattered to other page ids come
    back bit for bit, scales included, and the tier serves an 8-bit pool."""
    eng = Engine(ServerArgs(device="cpu", max_total_tokens=256, host_kv_cache_tokens=4096,
                            kv_cache_dtype="auto" if kv == "float32" else kv, **ARGS))
    runner = eng.scheduler.runner
    eng.generate(input_ids=prompt(40, 3), sampling_params=SamplingParams(max_new_tokens=2, **GREEDY))
    src, dst = np.array([1, 2, 5]), np.array([30, 31, 40])
    got = runner.gather_pages(src)
    assert len(got) == (4 if kv != "float32" else 2)
    runner.scatter_pages(dst, got)
    for t in runner._pool_tensors():
        assert t[:, src].any()
        assert torch.equal(t[:, src].view(torch.uint8), t[:, dst].view(torch.uint8))
    eng.flush_cache()
    sp = dict(max_new_tokens=4, **GREEDY)
    first = eng.generate(input_ids=prompt(96, 0), sampling_params=SamplingParams(**sp)).output_ids
    for seed in range(3):
        eng.generate(input_ids=prompt(96, 10 + seed), sampling_params=SamplingParams(**sp))
    again = eng.generate(input_ids=prompt(96, 0), sampling_params=SamplingParams(**sp))
    assert eng.scheduler.host_tier.restored_pages > 0 and again.output_ids == first


def test_latent_pool_pages_round_trip():
    """DeepSeek's latent pool (one tensor, no V) gathers and scatters."""
    from test_torch_deepseek import configs

    eng = Engine(ServerArgs(device="cpu", random_weights=True, dtype="float32", page_size=4,
                            max_total_tokens=256), model_config=configs()[1])
    runner = eng.scheduler.runner
    eng.generate(input_ids=prompt(20, 4), sampling_params=SamplingParams(max_new_tokens=2, **GREEDY))
    got = runner.gather_pages(np.array([1, 2]))
    assert len(got) == 1
    runner.scatter_pages(np.array([20, 21]), got)
    assert torch.equal(runner.kv_cache.k[:, [1, 2]], runner.kv_cache.k[:, [20, 21]])


# ------------------------------------------------------------------ resize


def test_resize_kv_pool():
    jeng, eng = make_pair(max_total_tokens=1024)
    sp = dict(max_new_tokens=8, **GREEDY)
    p = prompt(15, 9)
    before = gen_both(jeng, eng, p, **sp)[1]
    assert eng.scheduler.allocator.num_pages == 1024 // 4 + 1
    for tokens in (4096, 512):
        assert eng.resize_kv_pool(tokens) == jeng.resize_kv_pool(tokens) == tokens
        assert eng.scheduler.allocator.num_pages == tokens // 4 + 1
        assert eng.scheduler.runner.kv_cache.k.shape[1] == tokens // 4 + 1
        out = gen_both(jeng, eng, p, **sp)[1]
        assert out.output_ids == before.output_ids and out.cached_tokens == 0
    eng.scheduler.check_memory_leak()


@pytest.mark.parametrize("algo", ["draft", "eagle"])
def test_resize_carries_the_speculative_pools(algo):
    """The draft's pool and the EAGLE head's follow the target's resize
    (the JAX scheduler resizes the draft's alone)."""
    kw = dict(speculative_algorithm=algo)
    if algo == "draft":
        kw["speculative_draft_preset"] = "tiny-debug"
    eng = Engine(ServerArgs(device="cpu", max_total_tokens=1024, **ARGS, **kw))
    sp = SamplingParams(max_new_tokens=10, **GREEDY)
    before = eng.generate(input_ids=[5, 6, 7, 8] * 4, sampling_params=sp).output_ids
    eng.resize_kv_pool(4096)
    sched = eng.scheduler
    pool = sched.draft_runner.kv_cache if algo == "draft" else sched.eagle.kv_cache
    assert pool.k.shape[1] == sched.allocator.num_pages == 4096 // 4 + 1
    assert eng.generate(input_ids=[5, 6, 7, 8] * 4, sampling_params=sp).output_ids == before
    sched.check_memory_leak()


# ----------------------------------------------------------------- weights


def _hf_state(model: LlamaForCausalLM) -> dict:
    """A copy of the model's weights under their HF names (the inverse of
    ``convert_hf_state``)."""
    inv = {v: k for k, v in LlamaForCausalLM.HF_LAYER_MAP.items()}
    out = {}
    for name, t in model.state_dict().items():
        t = t.clone()
        if name.startswith("layers."):
            _, l, sub = name.split(".", 2)
            out[f"model.layers.{l}.{inv[sub]}"] = t.numpy()
        else:
            out[{"embed.weight": "model.embed_tokens.weight", "final_norm": "model.norm.weight",
                 "lm_head.weight": "lm_head.weight"}[name]] = t.numpy()
    return out


def test_update_weights_changes_output_and_rolls_back():
    """New weights (the JAX model's init at another seed) change the tokens
    on both engines alike; the old ones bring them back; a bad state leaves
    the weights as they were."""
    from scratchpad_tpu.models.llama import LlamaForCausalLM as JaxLlama

    jeng, eng = make_pair()
    p, sp = prompt(12, 9), dict(max_new_tokens=5, temperature=0.0)
    before = gen_both(jeng, eng, p, **sp)[1].output_ids
    new = JaxLlama(jeng.model_config).init_params(jax.random.PRNGKey(123), "float32")
    runner = eng.scheduler.runner
    old_state = _hf_state(runner.model)
    new_state = params_from_jax(jax.tree.map(np.asarray, new), eng.model_config)
    ok, msg = eng.update_weights(state=new_state)  # the model's own names
    assert ok, msg
    jold = jeng.scheduler.runner.params
    jeng.scheduler.runner.params = new
    jeng.flush_cache()
    after = gen_both(jeng, eng, p, **sp)[1].output_ids
    assert after != before
    ok, msg = eng.update_weights(state=old_state)  # HF names
    assert ok, msg
    jeng.scheduler.runner.params = jold
    jeng.flush_cache()
    assert gen_both(jeng, eng, p, **sp)[1].output_ids == before

    w0 = runner.model.layers[0].wq.weight.clone()
    for bad in ({"bogus.weight": np.zeros((2, 2))},
                {**old_state, "model.layers.0.self_attn.q_proj.weight": np.zeros((3, 3), np.float32)}):
        ok, msg = eng.update_weights(state=bad)
        assert not ok and "rolled back" in msg
        jok, jmsg = jeng.scheduler.runner.update_weights({"bogus.weight": np.zeros((2, 2))})
        assert not jok and "rolled back" in jmsg
    assert torch.equal(runner.model.layers[0].wq.weight, w0)
    assert eng.generate(input_ids=p, sampling_params=SamplingParams(**sp)).output_ids == before


def test_update_weights_requantizes_a_w4a8_engine():
    """A W4A8 engine quantizes the new dense weights again: its tokens after
    an update to another engine's weights equal that W4A8 engine's."""
    a = Engine(ServerArgs(device="cpu", max_total_tokens=1024, quantization="w4a8", **ARGS))
    b = Engine(ServerArgs(device="cpu", max_total_tokens=1024, quantization="w4a8", random_seed=5, **ARGS))
    dense = LlamaForCausalLM(b.model_config, torch.device("cpu"), torch.float32)
    dense.init_random_(torch.Generator().manual_seed(5))
    sp = SamplingParams(max_new_tokens=8, **GREEDY)
    p = prompt(14, 2)
    ok, msg = a.update_weights(state=_hf_state(dense))
    assert ok, msg
    assert a.generate(input_ids=p, sampling_params=sp).output_ids == b.generate(
        input_ids=p, sampling_params=sp).output_ids
    for k, v in b.scheduler.runner.model.state_dict().items():
        assert torch.equal(a.scheduler.runner.model.state_dict()[k], v), k


# ----------------------------------------------------------------- offload


def test_param_offload_matches_resident():
    jref, ref = make_pair()
    off = Engine(ServerArgs(device="cpu", max_total_tokens=2048, enable_param_offload=True,
                            param_offload_groups=2, **ARGS))
    load(off, jref)
    runner = off.scheduler.runner
    assert runner.param_offload is not None and len(runner.param_offload.groups) == 2
    assert not any(k.startswith("layers.") for k in runner.model.state_dict())
    for ps in ([prompt(18, 11), prompt(7, 12)],):
        sp = dict(max_new_tokens=12, **GREEDY)
        a = ref.generate(input_ids=ps, sampling_params=[SamplingParams(**sp)] * 2, return_logprob=True)
        b = off.generate(input_ids=ps, sampling_params=[SamplingParams(**sp)] * 2, return_logprob=True)
        j = jref.generate(input_ids=ps, sampling_params=[JaxSamplingParams(**sp)] * 2)
        assert [o.output_ids for o in a] == [o.output_ids for o in b] == [o.output_ids for o in j]
        assert [o.output_token_logprobs for o in a] == [o.output_token_logprobs for o in b]
    out = off.generate(input_ids=prompt(9, 13),
                       sampling_params=SamplingParams(temperature=0.8, max_new_tokens=6, ignore_eos=True))
    assert len(out.output_ids) == 6
    ok, msg = off.update_weights(state=_hf_state(ref.scheduler.runner.model))
    assert ok, msg
    off.scheduler.check_memory_leak()


def test_param_offload_refuses_other_models():
    from scratchpad_tpu_torch.config.model_config import get_preset

    with pytest.raises(ValueError, match="Llama-family"):
        Engine(ServerArgs(device="cpu", max_total_tokens=1024, enable_param_offload=True, **ARGS),
               model_config=get_preset("tiny-gemma2", dtype="float32"))


# -------------------------------------------------------------------- HTTP


def test_memory_routes_over_http(tmp_path):
    """``/memory_pool`` resizes the pool; ``/update_weights`` reloads a
    checkpoint directory (500 with the message for one that does not fit);
    both as the JAX server answers them."""
    from scratchpad_tpu_torch.server.http_server import ServerApp, ServerThread

    eng = Engine(ServerArgs(device="cpu", max_total_tokens=1024, **ARGS))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        eng.args.port = s.getsockname()[1]
    save_file(_hf_state(eng.scheduler.runner.model), os.path.join(tmp_path, "model.safetensors"))
    bad = tmp_path / "bad"
    bad.mkdir()
    save_file({"model.norm.weight": np.ones(3, np.float32)}, os.path.join(bad, "model.safetensors"))
    srv = ServerThread(ServerApp(eng, eng.args))

    def post(path, body):
        req = urllib.request.Request(f"http://127.0.0.1:{eng.args.port}{path}", data=json.dumps(body).encode())
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    try:
        assert post("/memory_pool", {"max_total_tokens": 4096}) == (200, {"status": "ok", "max_total_tokens": 4096})
        assert eng.scheduler.allocator.num_pages == 4096 // 4 + 1
        assert post("/memory_pool", {"max_total_tokens": -1})[0] == 400
        assert post("/update_weights", {"model_path": str(tmp_path)}) == (200, {"status": "ok", "message": "ok"})
        status, out = post("/update_weights", {"model_path": str(bad)})
        assert status == 500 and "rolled back" in out["message"]
        assert post("/update_weights", {})[0] == 400
    finally:
        srv.stop()
