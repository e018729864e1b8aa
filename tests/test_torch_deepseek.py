"""The port's DeepSeek-V2 and V3 against the JAX package's and HF's, on the CPU
in f32; HF transformers and the engines in two files beside it.

A tiny config from one HF-style dict (3 layers: 1 dense, then 2 MoE with 8
routed experts, top 2, and one shared expert; 4 heads, kv_lora_rank 32,
qk_nope 16, qk_rope 8, v 16; 4 expert groups):

- ``mla_attention`` and ``write_latent`` against the JAX
  ``mla_attention_xla`` and ``write_latent`` over one random latent pool,
  extend (a chunk after a cached prefix beside a fresh prompt) and decode
  (a padding row among them): within 1e-5; decode in row blocks under a
  gather budget equal to one block.
- Logits of extend steps and teacher-forced decode steps, both sides built
  from one seeded JAX pytree (its norms moved, V3's correction bias drawn)
  through ``params_from_jax``: V2 without and with ``q_lora_rank``,
  ``group_limited_greedy`` and V3 ``noaux_tc``. Tolerance 1e-4,
  ``tests/test_torch_model.py``'s.
- HF transformers and the JAX V3 scale gap: ``tests/test_torch_deepseek_hf.py``;
  the engines' greedy ids: ``tests/test_torch_deepseek_engine.py`` (each
  its own file, so that the six-worker run spreads them).
- The refusals and the pool's bytes a token.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scratchpad_tpu.config.model_config import ModelConfig as JaxModelConfig
from scratchpad_tpu.executor.forward_meta import ForwardMeta as JaxMeta
from scratchpad_tpu.executor.forward_meta import ForwardMode as JaxMode
from scratchpad_tpu.memory.kv_cache import KVCacheConfig as JaxKVConfig
from scratchpad_tpu.memory.kv_cache import create_kv_cache as jax_create_kv_cache
from scratchpad_tpu.models.registry import get_model_class as jax_get_model_class
from scratchpad_tpu.ops.attention.mla_backend import mla_attention_xla
from scratchpad_tpu.ops.attention.mla_backend import write_latent as jax_write_latent
from scratchpad_tpu_torch.config import ModelConfig, ServerArgs
from scratchpad_tpu_torch.executor.forward_meta import ForwardMeta, ForwardMode
from scratchpad_tpu_torch.executor.weight_loader import params_from_jax
from scratchpad_tpu_torch.memory.kv_cache import KVCache, KVCacheConfig, create_kv_cache
from scratchpad_tpu_torch.models.registry import get_model_class
from scratchpad_tpu_torch.ops.attention import mla_backend
from scratchpad_tpu_torch.ops.attention.mla_backend import mla_attention, write_latent
from scratchpad_tpu_torch.server.engine import Engine
from test_torch_model import PS, TOL, Pair, _extend_and_decode
import torch_threads  # noqa: F401  (one torch thread a test process)

TINY = dict(
    architectures=["DeepseekV2ForCausalLM"], vocab_size=512, hidden_size=64, intermediate_size=128,
    num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=4, max_position_embeddings=1280,
    rms_norm_eps=1e-5, rope_theta=10000.0, tie_word_embeddings=False, q_lora_rank=None,
    kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16, n_routed_experts=8,
    num_experts_per_tok=2, moe_intermediate_size=32, n_shared_experts=1, first_k_dense_replace=1,
    routed_scaling_factor=1.0, norm_topk_prob=False, topk_method="greedy", n_group=4, topk_group=2,
)
LATENT = TINY["kv_lora_rank"] + TINY["qk_rope_head_dim"]
V3 = dict(architectures=["DeepseekV3ForCausalLM"], topk_method="noaux_tc", norm_topk_prob=True,
          routed_scaling_factor=2.5)
VARIANTS = {
    "v2": {},
    "v2-q-lora": dict(q_lora_rank=24),
    "group-limited": dict(topk_method="group_limited_greedy"),
    "v3-noaux-tc": V3,
}
# YaRN on 32 positions, factor 40 (DeepSeek-V2-Lite's and V3's factor):
# mscale 1 over mscale_all_dim 0.707 scales the rope dims' cos and sin by
# 1.086; V3's published pair (1, 1) scales V3's scores by 1.874
YARN = {"type": "yarn", "factor": 40.0, "original_max_position_embeddings": 32, "beta_fast": 32.0,
        "beta_slow": 1.0, "mscale": 1.0, "mscale_all_dim": 0.707}
V3_YARN = dict(YARN, mscale_all_dim=1.0)


def configs(**overrides):
    """The JAX and the port config from one HF-style dict."""
    d = dict(TINY, **overrides)
    return (JaxModelConfig.from_hf_config(d, dtype="float32"),
            ModelConfig.from_hf_config(d, dtype="float32"))


def perturbed(params: dict, seed: int) -> dict:
    """The JAX pytree (numpy, f32) with every norm moved by 0.1 N(0, 1) and
    V3's correction bias drawn at 0.1 N(0, 1): the init leaves them at one
    and zero."""
    rng = np.random.default_rng(seed)

    def move(name, a):
        a = np.asarray(a, np.float32)
        if name.endswith("norm") or name == "router_bias":
            return a + 0.1 * rng.normal(size=a.shape).astype(np.float32)
        return a

    out = {k: move(k, v) for k, v in params.items() if not k.startswith("layers")}
    for g in ("layers_dense", "layers"):
        out[g] = {k: move(k, v) for k, v in params[g].items()}
    return out


def latent_pools(L, num_pages, jax_dtype=jnp.float32, dtype=torch.float32):
    jkv = jax_create_kv_cache(JaxKVConfig(num_layers=L, num_pages=num_pages, page_size=PS,
                                          num_kv_heads=1, head_dim=LATENT, dtype=jax_dtype, mla=True))
    kv = create_kv_cache(KVCacheConfig(L, num_pages, PS, 1, LATENT, dtype, mla=True), torch.device("cpu"))
    return jkv, kv


class DeepseekPair(Pair):
    """The JAX and the port DeepSeek on one perturbed JAX pytree, each with
    its latent pool (``Pair.step`` drives both)."""

    def __init__(self, num_pages=64, **overrides):
        self.jcfg, self.cfg = configs(**overrides)
        arch = self.cfg.architecture
        self.jmodel = jax_get_model_class(arch)(self.jcfg)
        self.jmodel.page_size = PS
        params = perturbed(jax.tree.map(np.asarray, self.jmodel.init_params(
            jax.random.PRNGKey(0), jnp.float32)), seed=1)
        self.params = jax.tree.map(jnp.asarray, params)
        self.model = get_model_class(arch)(self.cfg, torch.device("cpu"), torch.float32)
        self.model.load_state_dict(params_from_jax(params, self.cfg))
        self.jkv, self.kv = latent_pools(self.cfg.num_hidden_layers, num_pages)


def metas(mode, rows, B_pad=0):
    """The JAX and the port metadata of one batch: rows (new tokens, start
    position, pages); ``B_pad`` padding rows after them (decode)."""
    toks, pos, loc, req = [], [], [], []
    for i, (n, start, pages) in enumerate(rows):
        p = np.arange(start, start + n)
        toks.append(np.ones(n, np.int64))
        pos.append(p)
        loc.append(pages[p // PS] * PS + p % PS)
        req.append(np.full(n, i))
    ext = [r[0] for r in rows] + [0] * B_pad
    seq = [r[1] + r[0] for r in rows] + [0] * B_pad
    pt = np.zeros((len(ext), max(len(r[2]) for r in rows)), np.int32)
    for i, r in enumerate(rows):
        pt[i, : len(r[2])] = r[2]
    cu = np.concatenate([[0], np.cumsum(ext)]).astype(np.int32)
    arrays = dict(
        tokens=np.concatenate(toks + [np.zeros(B_pad, np.int64)]),
        positions=np.concatenate(pos + [np.zeros(B_pad, np.int64)]),
        out_cache_loc=np.concatenate(loc + [np.zeros(B_pad, np.int64)]),
        req_indices=np.concatenate(req + [np.arange(len(rows), len(ext))]),
        page_table=pt, seq_lens=np.asarray(seq, np.int32), extend_lens=np.asarray(ext, np.int32),
        last_token_idx=np.maximum(cu[1:] - 1, 0),
    )
    jmeta = JaxMeta(mode=JaxMode(mode.value), **{k: jnp.asarray(v, jnp.int32) for k, v in arrays.items()})
    meta = ForwardMeta(mode=mode, cu_q_lens=torch.from_numpy(cu), **{
        k: torch.from_numpy(np.asarray(v)).to(
            torch.int32 if k in ("page_table", "seq_lens", "extend_lens") else torch.long)
        for k, v in arrays.items()
    })
    return jmeta, meta


@pytest.mark.parametrize("mode", [ForwardMode.EXTEND, ForwardMode.DECODE])
def test_mla_attention_matches_jax(mode):
    """One random latent pool on both sides (layer 1 of 2); the step's new
    rows written by ``write_latent`` on both, the pools then equal; the
    weighted latent of every real token within 1e-5."""
    rng = np.random.default_rng(3)
    L, pages_per_layer, Hq, r, dr = 2, 16, 4, TINY["kv_lora_rank"], TINY["qk_rope_head_dim"]
    jkv, kv = latent_pools(L, pages_per_layer)
    pool = rng.normal(size=kv.k.shape).astype(np.float32)
    jkv = dataclasses.replace(jkv, kv=jnp.asarray(pool.reshape(jkv.kv.shape)))
    kv.k.copy_(torch.from_numpy(pool))
    pages = [np.arange(1, 9), np.arange(9, 16)]
    if mode == ForwardMode.EXTEND:  # a 7-token chunk after 9 cached tokens, a fresh 12-token prompt
        rows, pad = [(7, 9, pages[0]), (12, 0, pages[1])], 0
    else:  # one token each at positions 20 and 3, and a padding row
        rows, pad = [(1, 20, pages[0]), (1, 3, pages[1])], 1
    jmeta, meta = metas(mode, rows, pad)
    T = len(meta.tokens)
    lat = rng.normal(size=(T, r + dr)).astype(np.float32)
    jkv = jax_write_latent(jkv, jnp.asarray(lat), jnp.int32(1), jmeta.out_cache_loc)
    write_latent(kv, torch.from_numpy(lat), 1, meta.out_cache_loc)
    np.testing.assert_array_equal(kv.k.numpy().reshape(np.asarray(jkv.kv).shape), np.asarray(jkv.kv))
    q_lat = rng.normal(size=(T, Hq, r)).astype(np.float32)
    q_rope = rng.normal(size=(T, Hq, dr)).astype(np.float32)
    want = np.asarray(mla_attention_xla(jnp.asarray(q_lat), jnp.asarray(q_rope), jkv, jnp.int32(1), jmeta,
                                        page_size=PS, sm_scale=0.2))
    got = mla_attention(torch.from_numpy(q_lat), torch.from_numpy(q_rope), kv, 1, meta, sm_scale=0.2)
    real = sum(n for n, _, _ in rows)
    np.testing.assert_allclose(got.numpy()[:real], want[:real], rtol=1e-5, atol=1e-5)
    assert torch.isfinite(got).all()


def test_mla_decode_row_blocks_match_one_block(monkeypatch):
    """Decode under a gather budget of one row a block (three blocks, the
    last a padding row) gives the one-block result bit for bit."""
    rng = np.random.default_rng(4)
    Hq, r, dr = 4, TINY["kv_lora_rank"], TINY["qk_rope_head_dim"]
    _, kv = latent_pools(2, 16)
    kv.k.copy_(torch.from_numpy(rng.normal(size=kv.k.shape).astype(np.float32)))
    _, meta = metas(ForwardMode.DECODE, [(1, 20, np.arange(1, 9)), (1, 3, np.arange(9, 16))], 1)
    q_lat = torch.from_numpy(rng.normal(size=(3, Hq, r)).astype(np.float32))
    q_rope = torch.from_numpy(rng.normal(size=(3, Hq, dr)).astype(np.float32))
    whole = mla_attention(q_lat, q_rope, kv, 1, meta, sm_scale=0.2)
    monkeypatch.setattr(mla_backend, "DECODE_GATHER_BYTES", 1)
    blocked = mla_attention(q_lat, q_rope, kv, 1, meta, sm_scale=0.2)
    assert torch.equal(blocked, whole) and torch.isfinite(whole).all()


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_logits_match_jax(variant):
    """Extend (two fresh prompts, then a chunk after a cached prefix) and
    four teacher-forced decode steps: within 1e-4 of the JAX logits."""
    pair = DeepseekPair(**VARIANTS[variant])
    model = pair.model
    assert [layer.moe for layer in model.layers] == [False, True, True]
    assert model.noaux_tc == pair.jmodel.noaux_tc == (variant == "v3-noaux-tc")
    assert model.sm_scale == pair.jmodel.sm_scale  # no YaRN: the versions agree
    _extend_and_decode(pair, TOL)


def prompt_logits(model, tokens) -> torch.Tensor:
    """f32 logits [n, V] of every position of one prompt through the port
    model's extend on a fresh latent pool (page 4)."""
    n = len(tokens)
    pages = np.arange(1, -(-n // PS) + 1)
    kv = create_kv_cache(KVCacheConfig(model.cfg.num_hidden_layers, len(pages) + 1, PS, 1,
                                       model.mla_latent_dim, torch.float32, mla=True), torch.device("cpu"))
    pos = np.arange(n)
    meta = ForwardMeta(
        mode=ForwardMode.EXTEND, tokens=torch.tensor(tokens), positions=torch.from_numpy(pos),
        out_cache_loc=torch.from_numpy(pages[pos // PS] * PS + pos % PS),
        req_indices=torch.zeros(n, dtype=torch.long),
        page_table=torch.from_numpy(pages[None].astype(np.int32)),
        seq_lens=torch.tensor([n], dtype=torch.int32), extend_lens=torch.tensor([n], dtype=torch.int32),
        last_token_idx=torch.tensor([n - 1]), cu_q_lens=torch.tensor([0, n], dtype=torch.int32),
        capture_all_hidden=True,
    )
    with torch.inference_mode():
        return model.head_logits(model(meta, kv))


ENGINE_ARGS = dict(random_weights=True, dtype="float32", page_size=4, max_total_tokens=2048,
                   chunked_prefill_size=8)


def _engine(**kw):
    _, cfg = configs(**kw.pop("config", {}))
    return Engine(ServerArgs(device="cpu", **dict(ENGINE_ARGS, **kw)), model_config=cfg)


@pytest.mark.parametrize(
    "kw,match",
    [
        (dict(quantization="w4a8"), "quantization"),
        (dict(quantization="w4a16"), "quantization"),
        (dict(kv_cache_dtype="int8"), "8-bit latent"),
        (dict(kv_cache_dtype="fp8"), "8-bit latent"),
        (dict(attention_backend="pallas"), "pallas"),
        ("toppings", "toppings"),
        ("8-bit pool", "8-bit latent"),
    ],
    ids=["w4a8", "w4a16", "int8-kv", "fp8-kv", "pallas", "toppings", "kv-config"],
)
def test_refusals(kw, match):
    """Each unported option raises with a message, never served without it."""
    with pytest.raises(NotImplementedError, match=match):
        if kw == "toppings":
            _engine().register_topping("a", state={})
        elif kw == "8-bit pool":
            KVCacheConfig(3, 4, PS, 1, LATENT, torch.bfloat16, quantized=True, mla=True)
        else:
            _engine(**kw)


def test_latent_pool_bytes():
    """A latent pool counts L (r + dr) itemsize bytes a token, once: the
    engine's (f32 here; ``auto`` is the model dtype) and DeepSeek-V2-Lite's
    in bf16, 27 x 576 x 2 = 31,104 (16 expanded heads of K and V would take
    8.9x that). Its layout is [L, pages, page, 1, r + dr], with no V."""
    eng = _engine(kv_cache_dtype="auto")
    runner = eng.scheduler.runner
    assert runner.kv_bytes_per_token() == 3 * LATENT * 4
    kv: KVCache = runner.kv_cache
    assert kv.mla and kv.v is None and kv.k.shape[1:] == (runner.kv_config.num_pages, PS, 1, LATENT)
    with pytest.raises(ValueError, match="latent"):
        kv.layer(0)
    lite = KVCacheConfig(27, 0, 16, 1, 512 + 64, torch.bfloat16, mla=True)
    assert lite.bytes_per_token() == 31_104
    assert 27 * 16 * (192 + 128) * 2 / lite.bytes_per_token() == pytest.approx(8.89, abs=0.01)
