"""Gemma on 8-bit KV in the port (head_dim 256 on int8 and fp8 pages)
against the JAX package, on the CPU.

- The plain decode at head_dim 256 over 8-bit pages that the JAX package's
  ``write_kv`` quantized (``_quantize_rows``), each of Gemma's per-layer
  windows in turn (``LAYER_WINDOWS``: local, the global sentinel, local),
  against the JAX ``decode_attention_gqa`` with the window traced
  (interpret mode, as ``tests/test_pallas_kernels.py`` runs its
  dynamic-window int8 case) and ``decode_attention_xla``; the plain extend
  against ``extend_attention_xla``. Tolerance 2e-4, the JAX package's own
  for 8-bit pages.
- The Gemma 2 and Gemma 3 engines with ``kv_cache_dtype`` int8 and fp8
  against the JAX engine at the same setting, on one perturbed pytree:
  equal greedy ids, the port's top-2 margin above 1e-3 at every step, over
  prompts past the window (the radix hit and chunked prompts over 8-bit
  pages are ``tests/test_torch_kv_quant.py``'s).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scratchpad_tpu.config import ServerArgs as JaxServerArgs
from scratchpad_tpu.executor.forward_meta import ForwardMeta as JaxMeta
from scratchpad_tpu.executor.forward_meta import ForwardMode as JaxMode
from scratchpad_tpu.ops.attention.gqa_decode import decode_attention_gqa as jax_gqa
from scratchpad_tpu.ops.attention.xla_backend import decode_attention_xla, extend_attention_xla
from scratchpad_tpu.server.engine import Engine as JaxEngine
from scratchpad_tpu_torch.config import ServerArgs
from scratchpad_tpu_torch.config.model_config import get_preset
from scratchpad_tpu_torch.executor.forward_meta import ForwardMeta, ForwardMode
from scratchpad_tpu_torch.executor.weight_loader import params_from_jax
from scratchpad_tpu_torch.ops.attention import (
    attention_ragged,
    decode_attention_gqa,
    paged_decode_attention_quant,
    paged_extend_attention_quant,
)
from scratchpad_tpu_torch.ops.attention.gqa_decode import GLOBAL_WINDOW
from scratchpad_tpu_torch.server.engine import Engine
from test_torch_attention import LAYER, _decode_metas
from test_torch_gemma import CASES, LAYER_WINDOWS
from test_torch_kv_quant import TOL, _quant_pools
from test_torch_qwen import (
    ENGINE_ARGS,
    MARGIN,
    JaxSamplingParams,
    SamplingParams,
    _jax_cfg,
    _teacher_forced_margins,
    perturbed,
)
import torch_threads  # noqa: F401  (one torch thread a test process)

KV_DTYPES = ("int8", "fp8")


@pytest.mark.parametrize("kv_dtype, cap", [("int8", None), ("fp8", 50.0)])
def test_quant_decode_256_per_layer_windows_match_jax(kv_dtype, cap):
    """Three rows of up to five 16-token pages (one of length 0) at head_dim
    256, G 2, on one 8-bit pool, each window of ``LAYER_WINDOWS`` in turn."""
    seq_lens = np.asarray([70, 0, 33], np.int32)
    Hq, Hkv, D, ps = 4, 2, 256, 16
    rng, _, pt, jkv, tkv = _quant_pools(seq_lens.tolist(), Hkv, D, ps, kv_dtype, D, seed=17)
    assert tkv.quantized and tkv.k.shape[-1] == 256
    q = rng.normal(size=(len(seq_lens), Hq, D)).astype(np.float32)
    jm, tm = _decode_metas(pt, seq_lens)
    pad = seq_lens == 0
    before = paged_decode_attention_quant.launches
    outs = []
    for w in LAYER_WINDOWS:
        kw = dict(sm_scale=D**-0.5, logit_cap=cap)
        static = w if w < GLOBAL_WINDOW else None
        ref_gqa = np.asarray(
            jax_gqa(jnp.asarray(q), jkv, LAYER, jm, page_size=ps, sliding_window=jnp.int32(w), **kw)
        )
        ref_xla = np.array(
            decode_attention_xla(jnp.asarray(q), jkv, LAYER, jm, page_size=ps, sliding_window=static, **kw)
        )
        out = decode_attention_gqa(torch.from_numpy(q), tkv, LAYER, tm, sliding_window=w, **kw).numpy()
        ref_xla[pad] = 0.0
        np.testing.assert_allclose(out, ref_gqa, **TOL)
        np.testing.assert_allclose(out, ref_xla, **TOL)
        assert np.all(out[pad] == 0.0)
        outs.append(out)
    assert paged_decode_attention_quant.launches == before  # the plain version, on the CPU
    assert np.abs(outs[0] - outs[1]).max() > 1e-3 and np.abs(outs[2] - outs[1]).max() > 1e-3


@pytest.mark.parametrize("kv_dtype, cap", [("int8", 50.0), ("fp8", None)])
def test_quant_extend_256_per_layer_windows_match_jax(kv_dtype, cap):
    """A fresh prompt, a chunk after a 24-token cached prefix, a one-token
    row and padding at head_dim 256, G 3, each window of ``LAYER_WINDOWS``
    in turn, on one 8-bit pool."""
    chunks, Hq, Hkv, D, ps, T_pad = [(9, 9), (6, 30), (1, 13)], 6, 2, 256, 4, 20
    kv_lens = np.asarray([c[1] for c in chunks], np.int32)
    rng, _, pt, jkv, tkv = _quant_pools(kv_lens.tolist(), Hkv, D, ps, kv_dtype, D, seed=5)
    q_lens = np.asarray([c[0] for c in chunks], np.int32)
    cu = np.concatenate([[0], np.cumsum(q_lens)]).astype(np.int32)
    n_real, B = int(cu[-1]), len(chunks)
    T = max(T_pad, n_real)
    q = rng.normal(size=(T, Hq, D)).astype(np.float32)
    req = np.full(T, B - 1, np.int32)
    pos = np.zeros(T, np.int32)
    for s, (ql, kl) in enumerate(chunks):
        req[cu[s] : cu[s + 1]] = s
        pos[cu[s] : cu[s + 1]] = np.arange(kl - ql, kl)
    jm = JaxMeta(
        mode=JaxMode.EXTEND, tokens=jnp.zeros(T, jnp.int32), positions=jnp.asarray(pos),
        out_cache_loc=jnp.zeros(T, jnp.int32), req_indices=jnp.asarray(req),
        page_table=jnp.asarray(pt), seq_lens=jnp.asarray(kv_lens),
        extend_lens=jnp.asarray(q_lens), last_token_idx=jnp.asarray(cu[1:] - 1),
    )
    tm = ForwardMeta(
        mode=ForwardMode.EXTEND, tokens=torch.zeros(T, dtype=torch.long),
        positions=torch.from_numpy(pos).long(), out_cache_loc=torch.zeros(T, dtype=torch.long),
        req_indices=torch.from_numpy(req).long(), page_table=torch.from_numpy(pt),
        seq_lens=torch.from_numpy(kv_lens), extend_lens=torch.from_numpy(q_lens),
        last_token_idx=torch.from_numpy(cu[1:] - 1).long(), cu_q_lens=torch.from_numpy(cu),
    )
    before = paged_extend_attention_quant.launches
    outs = []
    for w in LAYER_WINDOWS:
        static = w if w < GLOBAL_WINDOW else None
        kw = dict(sm_scale=D**-0.5, logit_cap=cap)
        ref = np.asarray(extend_attention_xla(jnp.asarray(q), jkv, LAYER, jm, page_size=ps,
                                              sliding_window=static, **kw))
        out = attention_ragged(torch.from_numpy(q), tkv, LAYER, tm, sliding_window=w, **kw).numpy()
        np.testing.assert_allclose(out[:n_real], ref[:n_real], **TOL)
        assert np.all(out[n_real:] == 0.0)
        outs.append(out)
    assert paged_extend_attention_quant.launches == before
    assert np.abs(outs[0] - outs[1]).max() > 1e-3 and np.abs(outs[2] - outs[1]).max() > 1e-3


def kv8_engine_pair(case: str, kv_dtype: str):
    """The JAX engine and the port's with ``kv_cache_dtype`` on one perturbed
    pytree (``test_torch_qwen.engine_pair`` with an 8-bit pool)."""
    arch, preset, overrides = CASES[case]
    overrides = dict(overrides, head_dim=256)
    # one extend step a batch: the JAX engine compiles fewer shapes
    args = dict(ENGINE_ARGS, kv_cache_dtype=kv_dtype, chunked_prefill_size=64)
    jeng = JaxEngine(JaxServerArgs(**args, warmup_capture=False), model_config=_jax_cfg(arch, preset, **overrides))
    jrunner = jeng.scheduler.runner
    params = perturbed(jax.tree.map(np.asarray, jrunner.params), seed=2)
    jrunner.params = jax.tree.map(jnp.asarray, params)
    cfg = get_preset(preset, dtype="float32", architecture=arch, **overrides)
    eng = Engine(ServerArgs(device="cpu", **args), model_config=cfg)
    eng.scheduler.runner.model.load_state_dict(params_from_jax(params, eng.model_config))
    return jeng, eng


@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
@pytest.mark.parametrize("case", list(CASES))
def test_engine_greedy_on_8bit_kv_matches_jax(case, kv_dtype):
    """Two prompts past the window in one batch: equal greedy ids, each of
    the port's steps a top-2 margin above ``MARGIN``."""
    jeng, eng = kv8_engine_pair(case, kv_dtype)
    runner = eng.scheduler.runner
    assert runner.kv_cache_dtype == kv_dtype and runner.kv_cache.quantized
    assert runner.kv_cache.k.shape[-1] == 256
    rng = np.random.default_rng(44)
    prompts = [rng.integers(1, 500, n).tolist() for n in (21, 40)]
    outs = eng.generate(input_ids=prompts, sampling_params=[SamplingParams(temperature=0.0, max_new_tokens=10)] * 2)
    jouts = jeng.generate(input_ids=prompts,
                          sampling_params=[JaxSamplingParams(temperature=0.0, max_new_tokens=10)] * 2)
    for p, o, j in zip(prompts, outs, jouts):
        ids, margins = _teacher_forced_margins(eng, p, o.output_ids)
        assert ids == o.output_ids and min(margins) > MARGIN, min(margins)
        assert o.output_ids == j.output_ids and len(o.output_ids) == 10
    eng.scheduler.check_memory_leak()
