"""The port's Gemma 2 and Gemma 3 (text) against the JAX package's, on the CPU
in f32, its head_dim 256 attention with per-layer windows against the JAX
kernels', and Gemma 2 against HF transformers on the same random weights.

- Logits of extend and teacher-forced decode steps past the window, both
  sides built from one seeded JAX pytree through ``params_from_jax`` (its
  norms drawn at random): Gemma 2 (the ``tiny-gemma2`` preset: window 16
  on alternate layers, attention cap 50, final cap 30) and Gemma 3 (six
  layers, pattern 6, window 8, two rope bases, qk-norm). Tolerance 1e-4,
  ``tests/test_torch_model.py``'s.
- Greedy ids of each engine against the JAX engine's: equal, the port's
  top-2 margin above 1e-3 at every step, through chunks that cross the
  window's edge and a radix hit.
- The plain decode at head_dim 256 with Gemma's per-layer windows against
  the JAX ``decode_attention_gqa`` with a traced window (interpret mode, as
  ``tests/test_pallas_kernels.py`` runs its dynamic-window cases; its
  global sentinel 1 << 30 included) and ``decode_attention_xla``; the plain
  extend at head_dim 256 against ``extend_attention_xla``. Tolerance 2e-5,
  the JAX kernel tests' own.
- HF's ``Gemma2ForCausalLM`` (tiny, window 16, caps) and
  ``Gemma3ForCausalLM`` (pattern 6, window 8) carried into the port through
  ``convert_hf_state``: the logits of every position of a prompt longer
  than the window within 1e-4.
- What the port refuses for Gemma: quantization, toppings, the ``pallas``
  backend, 8-bit KV at head_dim 256.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scratchpad_tpu.models.gemma import GemmaForCausalLM as JaxGemma
from scratchpad_tpu.ops.attention.gqa_decode import decode_attention_gqa as jax_gqa
from scratchpad_tpu.ops.attention.xla_backend import decode_attention_xla, extend_attention_xla
from scratchpad_tpu_torch.config import ModelConfig, ServerArgs
from scratchpad_tpu_torch.config.model_config import get_preset
from scratchpad_tpu_torch.executor.model_runner import ModelRunner
from scratchpad_tpu_torch.memory.kv_cache import KVCacheConfig
from scratchpad_tpu_torch.models.gemma import GemmaForCausalLM, gemma_rms_norm
from scratchpad_tpu_torch.models.registry import get_model_class
from scratchpad_tpu_torch.ops.attention import (
    attention_ragged,
    decode_attention_gqa,
    decode_attention_plain,
)
from scratchpad_tpu_torch.ops.attention.gqa_decode import (
    GLOBAL_WINDOW,
    SPLIT_TARGET,
    WORKSPACE_BYTES,
    decode_plan,
    mask_args,
)
from scratchpad_tpu_torch.server.engine import Engine
from test_torch_attention import LAYER, _case, _decode_metas, _extend_inputs, _pools
from test_torch_model import TOL, _extend_and_decode
from test_torch_qwen import (
    ENGINE_ARGS,
    ArchPair,
    engine_pair,
    greedy_match,
    hf_random,
    port_from_hf,
    prompt_logits,
)
from test_torch_window import EXTEND_CASES
from test_torch_window import TOL as ATTN_TOL

GEMMA2 = ("Gemma2ForCausalLM", "tiny-gemma2", {})
# Gemma 3 at tiny-gemma2's widths: six layers (five local, one global), a
# window of 8, two rope bases (the global 1e6), no caps
GEMMA3 = (
    "Gemma3ForCausalLM", "tiny-gemma2",
    dict(num_hidden_layers=6, sliding_window=8, sliding_window_pattern=6, rope_theta=1e6,
         attn_logit_softcap=None, logit_softcap=None),
)
CASES = {"gemma2": GEMMA2, "gemma3": GEMMA3}


@pytest.mark.parametrize("case", list(CASES))
def test_logits_match_jax(case):
    """Extend (a chunk after a cached prefix included) and decode steps at
    positions up to 33, past the window."""
    arch, preset, overrides = CASES[case]
    pair = ArchPair(arch, preset, overrides)
    assert pair.cfg.use_qk_norm == (arch == "Gemma3ForCausalLM")
    _extend_and_decode(pair, TOL)


@pytest.mark.parametrize("case", list(CASES))
def test_layer_windows_match_jax(case):
    """Each layer's window is the JAX model's (``_layer_flags``), with its
    global sentinel read as None; the local layers take the local rope."""
    arch, preset, overrides = CASES[case]
    cfg = get_preset(preset, architecture=arch, **overrides)
    model = get_model_class(arch)(cfg, torch.device("cpu"), torch.float32)
    from scratchpad_tpu.config.model_config import get_preset as jax_get_preset

    jmodel = JaxGemma(jax_get_preset(preset, architecture=arch, **overrides))
    local, windows = jmodel._layer_flags()
    assert [model.is_local_layer(l) for l in range(cfg.num_hidden_layers)] == local.tolist()
    assert model.layer_windows() == [
        (mask_args(None, int(w))[1] or None) for w in windows
    ]
    assert any(w is None for w in model.layer_windows()) and any(model.layer_windows())
    np.testing.assert_array_equal(model.inv_freq_local.numpy(), jmodel.inv_freq_local)
    np.testing.assert_array_equal(model.inv_freq_global.numpy(), jmodel.inv_freq_global)


def test_gemma_rms_norm_scales_by_one_plus_w():
    x = torch.randn(3, 8, dtype=torch.bfloat16)
    w = torch.randn(8, dtype=torch.bfloat16)
    xf = x.float()
    ref = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + 1e-6) * (1 + w.float())
    out = gemma_rms_norm(x, w, 1e-6)
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out, ref.to(torch.bfloat16), rtol=0, atol=0)


@pytest.mark.parametrize("case", list(CASES))
def test_engine_greedy_matches_jax(case):
    """Greedy ids through chunks of 16 that cross the window's edge and a
    radix hit on a 40-token prefix."""
    arch, preset, overrides = CASES[case]
    jeng, eng = engine_pair(arch, preset, **overrides)
    rng = np.random.default_rng(41)
    prompts = [rng.integers(1, 500, n).tolist() for n in (21, 5, 40)]
    again = prompts[2][:36] + rng.integers(1, 500, 4).tolist()
    greedy_match(jeng, eng, prompts, again)


# ------------------------------------------------- attention at head_dim 256

# Gemma's layers in turn: local windows (17, then 5) and the JAX package's
# global sentinel
LAYER_WINDOWS = [17, 1 << 30, 5]


@pytest.mark.parametrize("cap", [None, 50.0])
def test_decode_256_per_layer_windows_match_jax(cap):
    """Three rows of up to five 16-token pages (one of length 0) at head_dim
    256, G 2, each window of ``LAYER_WINDOWS`` in turn on the same pool: the
    port's ``auto`` decode against the JAX kernel with the window traced and
    ``decode_attention_xla`` with it static."""
    seq_lens = np.asarray([70, 0, 33], np.int32)
    Hq, Hkv, D, ps = 4, 2, 256, 16
    rng, num_pages, pt, loc, k, v = _case(seq_lens.tolist(), Hkv, D, ps, seed=9)
    q = rng.normal(size=(len(seq_lens), Hq, D)).astype(np.float32)
    jm, tm = _decode_metas(pt, seq_lens)
    jkv, tkv = _pools(num_pages, ps, Hkv, D, loc, k, v, D)
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
        plain = decode_attention_plain(torch.from_numpy(q), tkv, LAYER, tm, sliding_window=static, **kw)
        pad = seq_lens == 0
        ref_xla[pad] = 0.0
        np.testing.assert_allclose(out, ref_gqa, **ATTN_TOL)
        np.testing.assert_allclose(out, ref_xla, **ATTN_TOL)
        np.testing.assert_array_equal(out, plain.numpy())
        assert np.all(out[pad] == 0.0)
        outs.append(out)
    # the windows cut: each layer's output differs from the global one's
    assert np.abs(outs[0] - outs[1]).max() > 1e-3 and np.abs(outs[2] - outs[1]).max() > 1e-3


@pytest.mark.parametrize("cap", [None, 50.0])
@pytest.mark.parametrize("chunks, Hq, Hkv, _D, ps, T_pad, window", EXTEND_CASES[:1])
def test_extend_256_per_layer_windows_match_jax(chunks, Hq, Hkv, _D, ps, T_pad, window, cap):
    """``test_torch_window.py``'s first extend case (a fresh prompt, a chunk
    after a 24-token cached prefix, a one-token row, padding) at head_dim
    256, each window of ``LAYER_WINDOWS`` in turn: the port's extend against
    ``extend_attention_xla``."""
    D = 256
    num_pages, pt, loc, k, v, q, kv_lens, q_lens, cu = _extend_inputs(chunks, Hq, Hkv, D, ps, T_pad, seed=3)
    T, n_real, B = q.shape[0], int(cu[-1]), len(chunks)
    from scratchpad_tpu.executor.forward_meta import ForwardMeta as JaxMeta
    from scratchpad_tpu.executor.forward_meta import ForwardMode as JaxMode
    from scratchpad_tpu_torch.executor.forward_meta import ForwardMeta, ForwardMode

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
    jkv, tkv = _pools(num_pages, ps, Hkv, D, loc, k, v, D)
    outs = []
    for w in LAYER_WINDOWS:
        static = w if w < GLOBAL_WINDOW else None
        kw = dict(sm_scale=D**-0.5, logit_cap=cap)
        ref = np.asarray(extend_attention_xla(jnp.asarray(q), jkv, LAYER, jm, page_size=ps,
                                              sliding_window=static, **kw))
        out = attention_ragged(torch.from_numpy(q), tkv, LAYER, tm, sliding_window=w, **kw).numpy()
        np.testing.assert_allclose(out[:n_real], ref[:n_real], **ATTN_TOL)
        assert np.all(out[n_real:] == 0.0)
        outs.append(out)
    assert np.abs(outs[0] - outs[1]).max() > 1e-3 and np.abs(outs[2] - outs[1]).max() > 1e-3


def test_global_sentinel_is_no_window():
    assert mask_args(None, 1 << 30) == (0.0, 0, 0)
    assert mask_args(None, GLOBAL_WINDOW - 1) == (0.0, GLOBAL_WINDOW - 1, 0)
    assert mask_args(50.0, 4096) == (50.0, 4096, 0)


@pytest.mark.parametrize("B, G, Hkv, pages", [(1, 2, 4, 512), (1, 4, 1, 512), (64, 2, 4, 512),
                                              (4, 4, 1, 256), (1, 8, 1, 2048)])
def test_decode_plan_holds_head_dim_256(B, G, Hkv, pages):
    """The split of Gemma-2-2B's and Gemma-3-1B's decode at head_dim 256:
    the partials (G (256 + 2) floats a split) fit the workspace, every page
    falls in one split, and a row of one kv head still reaches the card."""
    plan = decode_plan(B, Hkv, pages, 256, G)
    assert plan.partial_floats == G * 258
    assert plan.workspace_bytes <= WORKSPACE_BYTES
    assert plan.splits * plan.split_pages >= pages > (plan.splits - 1) * plan.split_pages
    assert (plan.splits > 1) == (B * Hkv < SPLIT_TARGET)


# ----------------------------------------------------------------- HF, refusals


HF_GEMMA = dict(
    vocab_size=512, hidden_size=128, intermediate_size=256, num_attention_heads=4,
    num_key_value_heads=2, head_dim=32, max_position_embeddings=1024, rms_norm_eps=1e-5,
    query_pre_attn_scalar=32,
)
HF_CASES = {
    # window 16 on alternate layers, caps 50 and 30
    "gemma2": ("Gemma2ForCausalLM", "Gemma2Config", dict(
        num_hidden_layers=4, rope_theta=10000.0, sliding_window=16, attn_logit_softcapping=50.0,
        final_logit_softcapping=30.0)),
    # window 8 on five layers of six, two rope bases, qk-norm
    "gemma3": ("Gemma3ForCausalLM", "Gemma3TextConfig", dict(
        num_hidden_layers=6, rope_theta=1e6, rope_local_base_freq=10000.0, sliding_window=8,
        sliding_window_pattern=6)),
}


@pytest.mark.parametrize("case", list(HF_CASES))
def test_logits_match_hf(case):
    """HF's model on its own random weights against the port's through
    ``convert_hf_state``, at every position of a 40-token prompt (past the
    window): within 1e-4. Its ``lm_head.weight`` (tied) is skipped."""
    import transformers

    arch, config_cls, extra = HF_CASES[case]
    kw = dict(HF_GEMMA, **extra)
    hf = hf_random(getattr(transformers, arch),
                   getattr(transformers, config_cls)(**kw, attn_implementation="eager"))
    assert "lm_head.weight" in hf.state_dict()
    model = port_from_hf(arch, ModelConfig.from_hf_config(dict(kw, architectures=[arch])), hf)
    tokens = np.random.default_rng(6).integers(1, 500, 40).tolist()
    with torch.no_grad():
        ref = hf(torch.tensor([tokens])).logits[0].float()
    np.testing.assert_allclose(prompt_logits(model, tokens).numpy(), ref.numpy(), **TOL)


def test_gemma_refuses_what_is_not_ported():
    cfg = get_preset("tiny-gemma2", dtype="float32")
    for quantization in ("w4a8", "w4a16"):
        with pytest.raises(NotImplementedError, match="quantization"):
            GemmaForCausalLM(cfg, torch.device("cpu"), torch.float32, quantization=quantization)
    args = dict(ENGINE_ARGS, preset="tiny-gemma2", device="cpu")
    with pytest.raises(NotImplementedError, match="pallas"):
        Engine(ServerArgs(attention_backend="pallas", **args))
    eng = Engine(ServerArgs(**args))
    with pytest.raises(NotImplementedError, match="toppings"):
        eng.register_topping("ad", state={}, scaling=1.0)
    assert eng.toppings_manager is None


@pytest.mark.parametrize("kv_cache_dtype", ["int8", "fp8"])
def test_8bit_kv_at_head_dim_256_is_refused(kv_cache_dtype):
    with pytest.raises(NotImplementedError, match="head_dim 256"):
        ServerArgs(preset="gemma-2-2b", device="cpu", kv_cache_dtype=kv_cache_dtype).resolve()
    with pytest.raises(NotImplementedError, match="head_dim 256"):
        KVCacheConfig(2, 8, 16, 4, 256, torch.bfloat16, quantized=True)
    cfg = get_preset("tiny-gemma2", dtype="float32", head_dim=256)
    with pytest.raises(NotImplementedError, match="head_dim 256"):
        ModelRunner(cfg, ServerArgs(device="cpu", dtype="float32", kv_cache_dtype=kv_cache_dtype,
                                    max_total_tokens=256, random_weights=True))
    # bf16 pages at head_dim 256 hold D lanes, no padding
    pool = KVCacheConfig(2, 8, 16, 4, 256, torch.bfloat16)
    assert pool.bytes_per_token() == 2 * 2 * 4 * 256 * 2
