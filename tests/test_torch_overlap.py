"""Pipelined decode windows and the rest of the engine, against the JAX package.

- ``enable_overlap=True`` with ``decode_pipeline_depth`` 2 and 3: the port's
  greedy tokens equal the JAX engine's under the same settings and the
  port's own with overlap off, over requests that finish in different
  windows (so a pipelined window runs past a request's end).
- Adapters in pipelined windows: the port's chained windows keep each
  request's adapter, so its tokens equal those with overlap off and the JAX
  engine's with overlap off. The JAX package's chained windows drop the
  adapters (``scheduler.py::_build_decode_wb_ahead`` builds no adapter
  table), which the last assertion of that test shows.
- MoE engines in pipelined windows: a tiny GPT-OSS engine (sinks, a window
  of 8 on its local layer) and a tiny Llama-4 engine (chunks of 8, a NoPE
  layer) with ``enable_overlap=True`` give the JAX engine's tokens with
  overlap off, on the same weights.
- The auto rule: overlap is off on the CPU in both packages and on for a
  CUDA runner in the port.
- ``encode``, ``score``, ``perplexity`` and sessions at the ``Engine``
  level.

tiny-debug in f32, page 4, windows of 4; the weights go over through
``params_from_jax``. Greedy prompts are fixed and guarded by
``torch_margins.top2_margin``.
"""

import time
import types

import jax
import numpy as np
import pytest
import torch

from scratchpad_tpu.config import ServerArgs as JaxServerArgs
from scratchpad_tpu.config.model_config import get_preset as jax_get_preset
from scratchpad_tpu.sampling.sampling_params import SamplingParams as JaxSamplingParams
from scratchpad_tpu.server.engine import Engine as JaxEngine
from scratchpad_tpu_torch.config import ServerArgs
from scratchpad_tpu_torch.config.model_config import get_preset
from scratchpad_tpu_torch.executor.weight_loader import params_from_jax
from scratchpad_tpu_torch.sampling.sampling_params import SamplingParams
from scratchpad_tpu_torch.server.engine import Engine
from test_torch_toppings import lora_state
from torch_margins import top2_margin
import torch_threads  # noqa: F401  (one torch thread a test process)

ARGS = dict(preset="tiny-debug", random_weights=True, dtype="float32", page_size=4,
            max_total_tokens=2048, decode_window_size=4)
MARGIN = 1e-3
PROMPTS = [np.random.default_rng(40 + i).integers(1, 500, n).tolist() for i, n in enumerate((7, 19, 33, 12))]
NEW = [13, 6, 17, 9]  # the requests end in different windows


def _port(params, **kw):
    eng = Engine(ServerArgs(device="cpu", **ARGS, **kw))
    eng.scheduler.runner.model.load_state_dict(params_from_jax(params, eng.model_config))
    return eng


def _greedy(eng, sp_cls, topping=None):
    sps = [sp_cls(temperature=0.0, max_new_tokens=n, ignore_eos=True) for n in NEW]
    outs = eng.generate(input_ids=PROMPTS, sampling_params=sps, topping=topping)
    return [o.output_ids for o in outs]


def _count_pipelined(eng):
    """Counts the scheduler's pipelined steps from now on."""
    sched, calls = eng.scheduler, [0]
    inner = sched._step_pipelined

    def counting():
        calls[0] += 1
        return inner()

    sched._step_pipelined = counting
    return calls


@pytest.fixture(scope="module")
def reference():
    jeng = JaxEngine(JaxServerArgs(**ARGS, enable_overlap=True, decode_pipeline_depth=2))
    params = jax.tree.map(np.asarray, jeng.scheduler.runner.params)
    return jeng, params


@pytest.mark.parametrize("depth", [2, 3])
def test_pipelined_windows_give_the_same_greedy_tokens(reference, depth):
    jeng, params = reference
    if depth != 2:
        jeng = JaxEngine(JaxServerArgs(**ARGS, enable_overlap=True, decode_pipeline_depth=depth))
    off = _port(params, enable_overlap=False)
    on = _port(params, enable_overlap=True, decode_pipeline_depth=depth)
    jcalls, calls = _count_pipelined(jeng), _count_pipelined(on)
    expect = _greedy(off, SamplingParams)
    for p, ids in zip(PROMPTS, expect):
        assert top2_margin(off, p, ids) > MARGIN, f"near tie on {p}"
    assert _greedy(on, SamplingParams) == expect
    assert _greedy(jeng, JaxSamplingParams) == expect
    assert calls[0] > 0 and jcalls[0] > 0  # both really pipelined
    assert not on.scheduler.has_work() and on.scheduler.num_running() == 0
    # every page is back once the radix cache is flushed
    on.flush_cache()
    alloc = on.scheduler.allocator
    assert alloc.available_pages == alloc.num_pages - 1


def test_pipelined_windows_keep_the_adapters(reference):
    _, params = reference
    tops = ["ad1", "ad1", None, "ad1"]
    runs = {}
    for label, eng_cls, sp_cls, overlap in (
        ("port on", None, SamplingParams, True), ("port off", None, SamplingParams, False),
        ("jax on", JaxEngine, JaxSamplingParams, True), ("jax off", JaxEngine, JaxSamplingParams, False),
    ):
        if eng_cls is None:
            eng = _port(params, enable_overlap=overlap)
        else:
            eng = JaxEngine(JaxServerArgs(**ARGS, enable_overlap=overlap))
        eng.register_topping("ad1", state=lora_state(eng.model_config, 4, 10), scaling=0.5)
        runs[label] = _greedy(eng, sp_cls, topping=tops)
    assert runs["port on"] == runs["port off"] == runs["jax off"]
    # the JAX package's chained windows decode the adapter rows without
    # their adapter; the base-model row is unaffected
    assert runs["jax on"][2] == runs["jax off"][2]
    assert runs["jax on"][0] != runs["jax off"][0]


def _moe_family(family: str):
    """The JAX and the port config of a tiny MoE engine, and the test
    module's perturbation of its weights (norms, biases and sinks moved)."""
    if family == "gpt-oss":
        from test_torch_moe import moe_perturbed

        cfgs = jax_get_preset("tiny-gpt-oss", dtype="float32"), get_preset("tiny-gpt-oss", dtype="float32")
        return (*cfgs, moe_perturbed)
    from test_torch_llama4 import configs, perturbed

    return (*configs("scout"), perturbed)


@pytest.mark.parametrize("family", ["gpt-oss", "llama4"])
def test_pipelined_windows_on_moe_engines(family):
    jcfg, cfg, perturbed = _moe_family(family)
    args = {k: v for k, v in ARGS.items() if k != "preset"}
    jeng = JaxEngine(JaxServerArgs(**args, enable_overlap=False, warmup_capture=False), model_config=jcfg)
    params = perturbed(jax.tree.map(np.asarray, jeng.scheduler.runner.params), seed=3)
    jeng.scheduler.runner.params = jax.tree.map(jax.numpy.asarray, params)
    on = Engine(ServerArgs(device="cpu", **args, enable_overlap=True), model_config=cfg)
    on.scheduler.runner.model.load_state_dict(params_from_jax(params, on.model_config))
    calls = _count_pipelined(on)
    expect = _greedy(jeng, JaxSamplingParams)
    for p, ids in zip(PROMPTS, expect):
        assert top2_margin(on, p, ids) > MARGIN, f"near tie on {p}"
    assert _greedy(on, SamplingParams) == expect
    assert calls[0] > 0  # the port really pipelined
    on.flush_cache()
    assert on.scheduler.allocator.available_pages == on.scheduler.allocator.num_pages - 1


def test_overlap_auto_rule(reference):
    jeng, params = reference
    jauto = JaxEngine(JaxServerArgs(**ARGS))
    auto = _port(params)
    jcalls, calls = _count_pipelined(jauto), _count_pipelined(auto)
    assert _greedy(auto, SamplingParams) == _greedy(jauto, JaxSamplingParams)
    assert calls[0] == jcalls[0] == 0  # off on the CPU in both packages
    assert auto.args.enable_overlap is None and not auto.scheduler.overlap_enabled()
    sched = auto.scheduler
    real = sched.runner
    try:
        sched.runner = types.SimpleNamespace(mesh=None, device=torch.device("cuda", 0))
        assert sched.overlap_enabled()  # on for a CUDA runner
        sched.args.enable_overlap = False
        assert not sched.overlap_enabled()
    finally:
        sched.runner, sched.args.enable_overlap = real, None


def test_encode_score_perplexity_match(reference):
    jeng, params = reference
    eng = _port(params)
    for ids in (PROMPTS[0], PROMPTS[2]):
        j, p = np.asarray(jeng.encode(input_ids=ids)), np.asarray(eng.encode(input_ids=ids))
        assert p.shape == (eng.model_config.hidden_size,)
        assert np.abs(j - p).max() <= 1e-5 and abs(np.linalg.norm(p) - 1) < 1e-5
        js, ps = jeng.score(ids), eng.score(ids)
        assert len(ps) == len(ids) - 1
        np.testing.assert_allclose(ps, js, atol=1e-4)
        assert abs(eng.perplexity(ids) - jeng.perplexity(ids)) <= 1e-4 * jeng.perplexity(ids)
    batch = eng.encode(input_ids=[PROMPTS[1], PROMPTS[3]])
    assert len(batch) == 2
    np.testing.assert_allclose(batch[1], jeng.encode(input_ids=PROMPTS[3]), atol=1e-5)
    # a sequence longer than the 128-row chunks of run_score's head
    long = np.random.default_rng(7).integers(1, 500, 300).tolist()
    np.testing.assert_allclose(eng.score(long), jeng.score(long), atol=1e-4)


def test_sessions_match(reference):
    jeng, params = reference
    eng = _port(params, max_sessions=2)
    sp = dict(temperature=0.0, max_new_tokens=5, ignore_eos=True)
    js, ps = jeng.open_session(), eng.open_session()
    for turn in (PROMPTS[0], PROMPTS[3]):
        j = jeng.session_generate(js, input_ids=turn, sampling_params=JaxSamplingParams(**sp))
        p = eng.session_generate(ps, input_ids=turn, sampling_params=SamplingParams(**sp))
        assert j.output_ids == p.output_ids and j.prompt_tokens == p.prompt_tokens
    assert p.prompt_tokens == len(PROMPTS[0]) + 5 + len(PROMPTS[3])
    assert p.cached_tokens > 0  # the second turn reuses the first's pages
    # LRU: a third session evicts the least recently used one
    first = eng.open_session()
    eng.open_session()
    assert ps not in eng._sessions and first in eng._sessions
    with pytest.raises(KeyError):
        eng.session_generate(ps, input_ids=[1, 2])
    eng.close_session(first)
    assert first not in eng._sessions
    eng.args.session_ttl = 0.05  # an idle session expires at the next sweep
    idle = eng.open_session()
    time.sleep(0.1)
    fresh = eng.open_session()
    assert idle not in eng._sessions and fresh in eng._sessions
    eng.shutdown()
    assert not eng._sessions
