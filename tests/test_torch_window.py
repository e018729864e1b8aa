"""The static sliding window and the attention soft cap of the port against
the JAX package's, on the CPU, in f32; and Mistral served under
``attention_backend`` ``auto`` and ``pallas``.

- Decode (the plain version of ``csrc/paged_decode_attention.cu``, through
  ``decode_attention_pallas`` and ``decode_attention_gqa``) against the JAX
  ``decode_attention_pallas`` and ``decode_attention_gqa`` in interpret mode
  and ``decode_attention_xla``, with ``seq_len == 0`` rows. Tolerance 2e-5,
  the JAX kernel tests' own; 8-bit pages 2e-4.
- Extend (the plain version of ``csrc/paged_extend_attention.cu``) against
  ``extend_attention_xla`` and the bundled ragged kernel's reference, the
  window's edge inside a chunk, inside a page and across a cached prefix.
  Tolerance 2e-5.
- Logits of a tiny Mistral (window 8) and of a tiny Llama with an attention
  cap of 30 against the JAX model on the same weights, through extend and
  decode past the window, bf16 and int8 KV: 1e-4 (int8: 1e-4 of max
  |logit|). Greedy tokens of a tiny Mistral engine against the JAX engine
  under both backends, through chunks that cross the window's edge and a
  radix hit on a 600-token prefix: equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas.ops.tpu.ragged_paged_attention import ref_ragged_paged_attention

from scratchpad_tpu.config import ServerArgs as JaxServerArgs
from scratchpad_tpu.config.model_config import ModelConfig as JaxModelConfig
from scratchpad_tpu.executor.forward_meta import ForwardMeta as JaxMeta
from scratchpad_tpu.executor.forward_meta import ForwardMode as JaxMode
from scratchpad_tpu.ops.attention.gqa_decode import decode_attention_gqa as jax_gqa
from scratchpad_tpu.ops.attention.pallas_decode import decode_attention_pallas as jax_pallas
from scratchpad_tpu.ops.attention.ragged_backend import _ragged_dense_ref
from scratchpad_tpu.ops.attention.xla_backend import decode_attention_xla, extend_attention_xla
from scratchpad_tpu.sampling.sampling_params import SamplingParams as JaxSamplingParams
from scratchpad_tpu.server.engine import Engine as JaxEngine
from scratchpad_tpu_torch.config import ModelConfig, ServerArgs
from scratchpad_tpu_torch.config.model_config import get_preset
from scratchpad_tpu_torch.executor.forward_meta import ForwardMeta, ForwardMode
from scratchpad_tpu_torch.executor.model_runner import ModelRunner, resolve_kv_cache_dtype
from scratchpad_tpu_torch.executor.weight_loader import params_from_jax
from scratchpad_tpu_torch.models.llama import LlamaForCausalLM
from scratchpad_tpu_torch.models.registry import get_model_class
from scratchpad_tpu_torch.ops import KERNEL_WRAPPERS
from scratchpad_tpu_torch.ops.attention import (
    attention_functions,
    attention_ragged,
    decode_attention_gqa,
    decode_attention_pallas,
    decode_attention_plain,
    extend_attention_plain,
    paged_decode_attention,
)
from scratchpad_tpu_torch.sampling.sampling_params import SamplingParams
from scratchpad_tpu_torch.server.engine import Engine
from test_torch_attention import LAYER, _case, _decode_metas, _extend_inputs, _pools
from test_torch_engine import _teacher_forced_margins
from test_torch_kv_quant import _logits_rel_check, _quant_pools
from test_torch_model import TOL as LOGIT_TOL
from test_torch_model import Pair, _extend_and_decode
import torch_threads  # noqa: F401  (one torch thread a test process)

TOL = dict(rtol=2e-5, atol=2e-5)
TOL_8BIT = dict(rtol=2e-4, atol=2e-4)
# (logit_cap, sliding_window); the window's edge falls inside a 16-token page
CAPS_WINDOWS = [(None, None), (30.0, None), (None, 8), (30.0, 8)]
MISTRAL = dict(architecture="MistralForCausalLM", sliding_window=8)
CAPPED_LLAMA = dict(attn_logit_softcap=30.0)


def _decode_case(seed):
    """``tests/test_pallas_kernels.py::make_case``'s shape (B 4, Hq 8, Hkv 2,
    D 64, page 16, up to 16 pages a row), rows 1 and 3 of length 0."""
    rng = np.random.default_rng(seed)
    seq_lens = rng.integers(1, 16 * 16, 4).astype(np.int32)
    seq_lens[[1, 3]] = 0
    return seq_lens


@pytest.mark.parametrize("cap, window", CAPS_WINDOWS)
def test_decode_matches_jax_pallas_and_xla(cap, window):
    """Row 9's counterpart (``decode_attention_pallas``) and the plain decode
    against the JAX ``decode_attention_pallas`` (interpret mode) and
    ``decode_attention_xla``."""
    Hq, Hkv, D, ps = 8, 2, 64, 16
    seq_lens = _decode_case(seed=3)
    rng, num_pages, pt, loc, k, v = _case(seq_lens.tolist(), Hkv, D, ps, seed=11)
    q = rng.normal(size=(len(seq_lens), Hq, D)).astype(np.float32)
    jm, tm = _decode_metas(pt, seq_lens)
    jkv, tkv = _pools(num_pages, ps, Hkv, D, loc, k, v, 128)  # the Pallas kernel's lanes
    kw = dict(sm_scale=0.125, logit_cap=cap, sliding_window=window)
    ref_pallas = np.asarray(jax_pallas(jnp.asarray(q), jkv, jnp.int32(LAYER), jm, page_size=ps, **kw))
    ref_xla = np.array(decode_attention_xla(jnp.asarray(q), jkv, LAYER, jm, page_size=ps, **kw))
    before = {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}
    out = decode_attention_pallas(torch.from_numpy(q), tkv, LAYER, tm, **kw).numpy()
    plain = decode_attention_plain(torch.from_numpy(q), tkv, LAYER, tm, **kw).numpy()
    assert {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS} == before  # CPU: no launch
    pad = seq_lens == 0
    ref_xla[pad] = 0.0  # the XLA reference leaves padding rows undefined
    np.testing.assert_allclose(out, ref_pallas, **TOL)
    np.testing.assert_allclose(out, ref_xla, **TOL)
    np.testing.assert_array_equal(out, plain)
    assert np.all(out[pad] == 0.0)


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
@pytest.mark.parametrize("cap, window", [(None, 8), (30.0, 100), (30.0, 1)])
def test_decode_gqa_window_matches_jax(kv_dtype, cap, window):
    """The ``auto`` decode with a static window and a cap, over bf16-layout
    and int8 pages, against the JAX ``decode_attention_gqa`` (interpret mode,
    whole chunks below the window skipped) and ``decode_attention_xla``."""
    seq_lens = np.asarray([300, 0, 17, 700], np.int32)
    Hq, Hkv, D, ps = 8, 2, 64, 16
    if kv_dtype is None:
        rng, num_pages, pt, loc, k, v = _case(seq_lens.tolist(), Hkv, D, ps, seed=5)
        jkv, tkv = _pools(num_pages, ps, Hkv, D, loc, k, v, 128)
        tol = TOL
    else:
        rng, _, pt, jkv, tkv = _quant_pools(seq_lens.tolist(), Hkv, D, ps, kv_dtype, 128, seed=5)
        tol = TOL_8BIT
    q = rng.normal(size=(len(seq_lens), Hq, D)).astype(np.float32)
    jm, tm = _decode_metas(pt, seq_lens)
    kw = dict(sm_scale=0.125, logit_cap=cap, sliding_window=window)
    ref_gqa = np.asarray(jax_gqa(jnp.asarray(q), jkv, LAYER, jm, page_size=ps, **kw))
    ref_xla = np.array(decode_attention_xla(jnp.asarray(q), jkv, LAYER, jm, page_size=ps, **kw))
    out = decode_attention_gqa(torch.from_numpy(q), tkv, LAYER, tm, **kw).numpy()
    pad = seq_lens == 0
    ref_xla[pad] = 0.0
    np.testing.assert_allclose(out, ref_gqa, **tol)
    np.testing.assert_allclose(out, ref_xla, **tol)
    assert np.all(out[pad] == 0.0)


EXTEND_CASES = [
    # page 4, window 8: a fresh prompt, a chunk after a 24-token cached
    # prefix, a one-token row, padding tokens
    ([(9, 9), (6, 30), (1, 13)], 8, 2, 32, 4, 20, 8),
    # page 16, window 5 (the edge inside every page): a chunked prefill's
    # second chunk beside a fresh prompt, G = 4, head_dim 64
    ([(16, 48), (20, 20)], 16, 4, 64, 16, 36, 5),
]


@pytest.mark.parametrize("cap", [None, 30.0])
@pytest.mark.parametrize("chunks, Hq, Hkv, D, ps, T_pad, window", EXTEND_CASES)
def test_extend_window_matches_jax(chunks, Hq, Hkv, D, ps, T_pad, window, cap):
    """The extend with a window (and a cap) against ``extend_attention_xla``
    and ``ref_ragged_paged_attention``, the bundled kernel's own reference
    (its ``sliding_window`` and ``soft_cap``), and, for the cap alone,
    ``_ragged_dense_ref`` (which keeps kv position 0 live in every row,
    ``ragged_backend.py:506``, so it is no reference under a window)."""
    num_pages, pt, loc, k, v, q, kv_lens, q_lens, cu = _extend_inputs(
        chunks, Hq, Hkv, D, ps, T_pad, seed=7 + D
    )
    T, n_real, B = q.shape[0], int(cu[-1]), len(chunks)
    scale = 1.0 / np.sqrt(D)
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
    qj = jnp.asarray(q)
    ref_xla = np.asarray(extend_attention_xla(
        qj, jkv, LAYER, jm, page_size=ps, sm_scale=scale, logit_cap=cap, sliding_window=window
    ))
    # the pages of layer LAYER sit at global page LAYER * num_pages + p
    pt_global = jnp.asarray(pt + LAYER * num_pages)
    ref_bundled = np.asarray(ref_ragged_paged_attention(
        qj, jkv.kv, jnp.asarray(kv_lens), pt_global, jnp.asarray(cu), jnp.asarray([B], jnp.int32),
        sm_scale=scale, sliding_window=window, soft_cap=cap,
    ))
    out = attention_ragged(
        torch.from_numpy(q), tkv, LAYER, tm, sm_scale=scale, logit_cap=cap, sliding_window=window
    ).numpy()
    plain = extend_attention_plain(
        torch.from_numpy(q), tkv, LAYER, tm, sm_scale=scale, logit_cap=cap, sliding_window=window
    ).numpy()
    np.testing.assert_allclose(out[:n_real], ref_xla[:n_real], **TOL)
    np.testing.assert_allclose(out[:n_real], ref_bundled, **TOL)
    np.testing.assert_array_equal(out, plain)
    assert np.all(out[n_real:] == 0.0)
    ref_dense = np.asarray(_ragged_dense_ref(
        qj * scale, jkv.kv, jnp.asarray(kv_lens), pt_global, jnp.asarray(cu),
        jnp.asarray([B], jnp.int32), sm_scale=1.0, logit_cap=cap, sliding_window=None,
    ))
    unwindowed = attention_ragged(torch.from_numpy(q), tkv, LAYER, tm, sm_scale=scale, logit_cap=cap)
    np.testing.assert_allclose(unwindowed.numpy()[:n_real], ref_dense[:n_real], **TOL)
    # the window reaches past the edge of at least one query of each case
    assert np.abs(unwindowed.numpy() - out).max() > 1e-2


def test_extend_blocks_queries_like_one_block(monkeypatch):
    """The plain extend scores its queries in blocks: a chunk longer than a
    block gives what one block gives."""
    from scratchpad_tpu_torch.ops.attention import ragged_backend

    num_pages, pt, loc, k, v, q, kv_lens, q_lens, cu = _extend_inputs(
        [(40, 70), (7, 7)], 8, 2, 32, 4, 50, seed=2
    )
    _, tkv = _pools(num_pages, 4, 2, 32, loc, k, v, 32)
    kl, vl, _, _ = tkv.layer(LAYER)
    args = (torch.from_numpy(q), kl, vl, torch.from_numpy(pt), torch.from_numpy(kv_lens),
            torch.from_numpy(cu), 0.2)
    whole = ragged_backend.paged_extend_attention_plain(*args, logit_cap=30.0, sliding_window=9)
    monkeypatch.setattr(ragged_backend, "QUERY_BLOCK", 16)
    blocked = ragged_backend.paged_extend_attention_plain(*args, logit_cap=30.0, sliding_window=9)
    np.testing.assert_allclose(blocked.numpy(), whole.numpy(), rtol=1e-6, atol=1e-6)


# ------------------------------------------------------ the model and engine


@pytest.mark.parametrize(
    "overrides, backend",
    [(MISTRAL, "auto"), (MISTRAL, "pallas"), (CAPPED_LLAMA, "auto"), (CAPPED_LLAMA, "pallas")],
    ids=["mistral-auto", "mistral-pallas", "capped-auto", "capped-pallas"],
)
def test_window_and_cap_logits_match_jax(overrides, backend):
    """Extend (a chunk after a cached prefix included) and decode steps at
    positions up to 33, past the window of 8."""
    pair = Pair(overrides, backend=backend)
    assert type(pair.model) is get_model_class(pair.cfg.architecture)
    _extend_and_decode(pair, LOGIT_TOL)


@pytest.mark.parametrize("overrides", [MISTRAL, CAPPED_LLAMA], ids=["mistral", "capped"])
def test_window_and_cap_logits_match_jax_int8_kv(overrides):
    _logits_rel_check(Pair(overrides, kv_dtype="int8"), seed=1)


def test_mistral_config_reads_as_in_jax():
    """A Mistral ``config.json`` (Mistral-7B-v0.1's published values) reads
    into the same fields on both sides: the window, head_dim from hidden /
    heads, and ``use_sliding_window: false`` turning the window off."""
    hf = dict(
        architectures=["MistralForCausalLM"], vocab_size=32000, hidden_size=4096,
        intermediate_size=14336, num_hidden_layers=32, num_attention_heads=32,
        num_key_value_heads=8, max_position_embeddings=32768, rms_norm_eps=1e-5,
        rope_theta=10000.0, sliding_window=4096, tie_word_embeddings=False,
        hidden_act="silu", model_type="mistral",
    )
    for d in (hf, dict(hf, use_sliding_window=False)):
        cfg, jcfg = ModelConfig.from_hf_config(d), JaxModelConfig.from_hf_config(d)
        for name in ("architecture", "head_dim", "sliding_window", "attn_logit_softcap",
                     "num_kv_heads", "rope_theta", "tie_word_embeddings"):
            assert getattr(cfg, name) == getattr(jcfg, name), name
    assert ModelConfig.from_hf_config(hf).head_dim == 128
    assert ModelConfig.from_hf_config(hf).sliding_window == 4096
    assert ModelConfig.from_hf_config(dict(hf, use_sliding_window=False)).sliding_window is None


def _mistral_hf(**kw):
    """tests/test_mistral.py's geometry, window 8."""
    return dict(
        architectures=["MistralForCausalLM"], vocab_size=512, hidden_size=128,
        intermediate_size=256, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2, head_dim=32, max_position_embeddings=1024, rms_norm_eps=1e-5,
        rope_theta=10000.0, sliding_window=8, tie_word_embeddings=False, **kw,
    )


ENGINE_ARGS = dict(
    random_weights=True, dtype="float32", page_size=4, max_total_tokens=2048,
    chunked_prefill_size=16,
)


@pytest.mark.parametrize("backend", ["auto", "pallas"])
def test_mistral_engine_matches_jax(backend):
    """Greedy tokens of a tiny Mistral engine against the JAX engine on the
    same weights: two 21-token prompts (chunks of 16: the second attends
    across the window's edge into the first), and two prompts that share a
    600-token prefix, the second a radix hit whose reused prefix is far
    longer than the window."""
    jeng = JaxEngine(
        JaxServerArgs(attention_backend=backend, **ENGINE_ARGS),
        model_config=JaxModelConfig.from_hf_config(_mistral_hf(), dtype="float32"),
    )
    eng = Engine(
        ServerArgs(device="cpu", attention_backend=backend, **ENGINE_ARGS),
        model_config=ModelConfig.from_hf_config(_mistral_hf(), dtype="float32"),
    )
    runner = eng.scheduler.runner
    assert runner.attention_backend == backend
    expected = {"auto": decode_attention_gqa, "pallas": decode_attention_pallas}[backend]
    assert runner.model.decode_attention is expected
    assert runner.model.extend_attention is attention_ragged
    params = jax.tree.map(np.asarray, jeng.scheduler.runner.params)
    runner.model.load_state_dict(params_from_jax(params, eng.model_config))

    rng = np.random.default_rng(21)
    shared = rng.integers(1, 500, 600).tolist()
    prompts = [rng.integers(1, 500, 21).tolist() for _ in range(2)]
    prompts += [shared + rng.integers(1, 500, 5).tolist()]
    again = shared + rng.integers(1, 500, 7).tolist()
    n_new = 10
    sp, jsp = SamplingParams(temperature=0.0, max_new_tokens=n_new), JaxSamplingParams(
        temperature=0.0, max_new_tokens=n_new
    )
    outs = eng.generate(input_ids=prompts, sampling_params=[sp] * len(prompts))
    jouts = jeng.generate(input_ids=prompts, sampling_params=[jsp] * len(prompts))
    out2 = eng.generate(input_ids=again, sampling_params=sp)
    jout2 = jeng.generate(input_ids=again, sampling_params=jsp)
    assert out2.cached_tokens == jout2.cached_tokens >= 596
    for p, o, j in zip(prompts + [again], outs + [out2], jouts + [jout2]):
        ids, margins = _teacher_forced_margins(eng, p, o.output_ids)
        assert ids == o.output_ids
        assert min(margins) > 1e-3, min(margins)
        assert o.output_ids == j.output_ids and len(o.output_ids) == n_new
    eng.scheduler.check_memory_leak()


# ------------------------------------------------------------- settings


def test_pallas_backend_resolves():
    args = ServerArgs(preset="tiny-debug", device="cpu", attention_backend="pallas").resolve()
    assert args.attention_backend == "pallas"
    assert attention_functions("pallas") == (decode_attention_pallas, attention_ragged)
    assert attention_functions("auto") == (decode_attention_gqa, attention_ragged)


@pytest.mark.parametrize("kv_cache_dtype", ["int8", "fp8"])
def test_pallas_backend_with_8bit_kv_raises(kv_cache_dtype):
    with pytest.raises(ValueError, match="bf16 pages only"):
        ServerArgs(
            preset="tiny-debug", device="cpu", attention_backend="pallas",
            kv_cache_dtype=kv_cache_dtype,
        ).resolve()


def test_pallas_backend_keeps_auto_kv_at_the_model_dtype():
    """The JAX runner's int8 auto rule holds only for its ``gqa`` backend:
    under ``pallas`` a W4 3B keeps bf16 KV, which that decode takes."""
    cfg = get_preset("llama-3.2-3b")
    for backend, want in (("auto", "int8"), ("pallas", "bfloat16")):
        args = ServerArgs(preset="llama-3.2-3b", quantization="w4a8", device="cpu",
                          attention_backend=backend).resolve()
        assert resolve_kv_cache_dtype(args, cfg, torch.device("cuda")) == want


def test_pallas_decode_refuses_8bit_pages():
    Hkv, D, ps = 2, 32, 4
    seq_lens = np.asarray([9, 3], np.int32)
    _, _, pt, _, tkv = _quant_pools(seq_lens.tolist(), Hkv, D, ps, "int8", 32, seed=1)
    _, tm = _decode_metas(pt, seq_lens)
    with pytest.raises(TypeError, match="bf16 pages"):
        decode_attention_pallas(torch.zeros(2, 4, D), tkv, LAYER, tm, sm_scale=0.1)


def test_model_without_pallas_support_is_refused_under_pallas():
    class NoPallas(LlamaForCausalLM):
        supports_pallas_attention = False

    runner = ModelRunner.__new__(ModelRunner)
    runner.args = ServerArgs(attention_backend="pallas")
    model = NoPallas(get_preset("tiny-debug"), torch.device("cpu"), torch.float32)
    with pytest.raises(NotImplementedError, match="pallas"):
        runner._set_attention(model)
    runner.args = ServerArgs(attention_backend="auto")
    assert runner._set_attention(model) == "auto"
    assert model.decode_attention is decode_attention_gqa


@pytest.mark.parametrize("cap, window", [(0.0, None), (-1.0, None), (None, 0), (None, -3)])
def test_wrappers_refuse_a_bad_cap_or_window(cap, window):
    Hkv, D, ps = 2, 32, 4
    _, num_pages, pt, loc, k, v = _case([9, 3], Hkv, D, ps, seed=5)
    _, tkv = _pools(num_pages, ps, Hkv, D, loc, k, v, D)
    kl, vl, _, _ = tkv.layer(LAYER)
    with pytest.raises(ValueError):
        paged_decode_attention(
            torch.zeros(2, 4, D), kl, vl, torch.from_numpy(pt),
            torch.tensor([9, 3], dtype=torch.int32), 0.1, cap, window,
        )
