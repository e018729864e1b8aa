"""The port's Llama against the JAX package's on the same weights, on the CPU
in f32, unquantized and with 4-bit weights (W4A8, W4A16): logits of extend
steps (fresh prompts, a chunk after a cached prefix) and of teacher-forced
decode steps agree within 1e-4.

Both models start from one seeded JAX parameter pytree, handed to the port
as numpy through ``params_from_jax``; each writes its own KV pool.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from scratchpad_tpu.config.model_config import get_preset as jax_get_preset
from scratchpad_tpu.executor.forward_meta import ForwardMeta as JaxMeta
from scratchpad_tpu.executor.forward_meta import ForwardMode as JaxMode
from scratchpad_tpu.memory.kv_cache import KVCacheConfig as JaxKVConfig
from scratchpad_tpu.memory.kv_cache import create_kv_cache as jax_create_kv_cache
from scratchpad_tpu.models.common import compute_inv_freq as jax_inv_freq
from scratchpad_tpu.models.common import make_w4a8_quant_matmul
from scratchpad_tpu.ops.quant import quantize_model_params as jax_quantize_model_params
from scratchpad_tpu.ops.quant import quantize_stacked as jax_quantize_stacked
from scratchpad_tpu.models.llama import LlamaForCausalLM as JaxLlama
from scratchpad_tpu_torch.config.model_config import get_preset
from scratchpad_tpu_torch.executor.forward_meta import ForwardMeta, ForwardMode
from scratchpad_tpu_torch.executor.weight_loader import params_from_jax
from scratchpad_tpu_torch.memory.kv_cache import KVCacheConfig, create_kv_cache
from scratchpad_tpu_torch.models.common import compute_inv_freq
from scratchpad_tpu_torch.models.llama import LlamaForCausalLM
from scratchpad_tpu_torch.ops.attention import attention_functions
import torch_threads  # noqa: F401  (one torch thread a test process)

TOL = dict(rtol=1e-4, atol=1e-4)
PS = 4
LLAMA3_ROPE = dict(
    rope_theta=500000.0,
    max_position_embeddings=4096,
    rope_scaling={
        "rope_type": "llama3", "factor": 32.0, "low_freq_factor": 1.0,
        "high_freq_factor": 4.0, "original_max_position_embeddings": 64,
    },
)
VARIANTS = {
    "tiny-debug": {},
    # Llama-3 rope scaling with an original context short enough that the
    # test's positions cross all three frequency bands; head_dim 64, G = 4
    "llama3-rope": dict(
        LLAMA3_ROPE, head_dim=64, num_attention_heads=8, num_key_value_heads=2,
        hidden_size=256,
    ),
}


class Pair:
    """The JAX and the port model on one weight state, each with its pool.

    ``quantization`` (w4a8 | w4a16): the JAX parameters are quantized as its
    runner does (``quantize_model_params(fuse_gate_up=True)`` and a 4-bit
    head, ``lm_head_q``) and its model gets the runner's matmul; the port
    loads the same codes through ``params_from_jax``. ``kv_dtype`` (int8 |
    fp8) gives both models 8-bit KV pools with per-(token, head) scales.
    ``backend``: the port model's attention functions, as the runner sets
    them for that ``attention_backend``."""

    def __init__(self, overrides, num_pages=64, quantization=None, kv_dtype=None, backend="auto"):
        self.jcfg = jax_get_preset("tiny-debug", dtype="float32", **overrides)
        self.cfg = get_preset("tiny-debug", dtype="float32", **overrides)
        self.jmodel = JaxLlama(self.jcfg)
        self.jmodel.page_size = PS
        self.params = self.jmodel.init_params(jax.random.PRNGKey(0), jnp.float32)
        if quantization is not None:
            self.params = jax_quantize_model_params(self.params, fuse_gate_up=True)
            head = self.params.pop("lm_head")  # tiny-debug's head is untied
            self.params["lm_head_q"] = jax_quantize_stacked(jnp.swapaxes(head, 0, 1)[None])
            if quantization == "w4a8":
                self.jmodel.quant_matmul = make_w4a8_quant_matmul()
        params_np = jax.tree.map(np.asarray, self.params)
        self.model = LlamaForCausalLM(
            self.cfg, torch.device("cpu"), torch.float32,
            quantization=quantization, quantize_lm_head=quantization is not None,
        )
        self.model.load_state_dict(params_from_jax(params_np, self.cfg))
        self.model.decode_attention, self.model.extend_attention = attention_functions(backend)
        L, Hkv, D = self.cfg.num_hidden_layers, self.cfg.num_kv_heads, self.cfg.head_dim
        jax_codes = {"int8": jnp.int8, "fp8": jnp.float8_e4m3fn}
        codes = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}
        self.jkv = jax_create_kv_cache(
            JaxKVConfig(num_layers=L, num_pages=num_pages, page_size=PS,
                        num_kv_heads=Hkv, head_dim=D, dtype=jnp.float32,
                        quantized=kv_dtype is not None,
                        quant_dtype=jax_codes.get(kv_dtype, jnp.int8))
        )
        self.kv = create_kv_cache(
            KVCacheConfig(L, num_pages, PS, Hkv, D, torch.float32,
                          quantized=kv_dtype is not None,
                          quant_dtype=codes.get(kv_dtype, torch.int8)),
            torch.device("cpu"),
        )

    def step(self, mode, rows, adapters=None):
        """rows: (tokens, start position, pages) per sequence; the step's
        tokens sit at positions start.. of each sequence. ``adapters``: the
        batch's (active_adapters, adapter_slots) where it names toppings.
        Returns both models' logits [B, V]."""
        toks, pos, loc, req = [], [], [], []
        for i, (t, start, pages) in enumerate(rows):
            p = np.arange(start, start + len(t))
            toks.append(t)
            pos.append(p)
            loc.append(pages[p // PS] * PS + p % PS)
            req.append(np.full(len(t), i))
        ext = np.asarray([len(r[0]) for r in rows], np.int32)
        seq = np.asarray([r[1] + len(r[0]) for r in rows], np.int32)
        pt = np.zeros((len(rows), max(len(r[2]) for r in rows)), np.int32)
        for i, r in enumerate(rows):
            pt[i, : len(r[2])] = r[2]
        cu = np.concatenate([[0], np.cumsum(ext)]).astype(np.int32)
        arrays = dict(
            tokens=np.concatenate(toks), positions=np.concatenate(pos),
            out_cache_loc=np.concatenate(loc), req_indices=np.concatenate(req),
            page_table=pt, seq_lens=seq, extend_lens=ext, last_token_idx=cu[1:] - 1,
        )
        jextra, extra = {}, {}
        if adapters is not None:
            active, slots = (np.asarray(a, np.int32) for a in adapters)
            jextra = dict(active_adapters=jnp.asarray(active), adapter_slots=jnp.asarray(slots))
            extra = dict(active_adapters=torch.from_numpy(active), adapter_slots=torch.from_numpy(slots))
        jmeta = JaxMeta(
            mode=JaxMode(mode.value), **{k: jnp.asarray(v, jnp.int32) for k, v in arrays.items()},
            **jextra,
        )
        self.jkv, jlogits = self.jmodel(self.params, self.jkv, jmeta)
        meta = ForwardMeta(
            mode=mode,
            cu_q_lens=torch.from_numpy(cu),
            **extra,
            **{
                k: torch.from_numpy(np.asarray(v)).to(
                    torch.int32 if k in ("page_table", "seq_lens", "extend_lens") else torch.long
                )
                for k, v in arrays.items()
            },
        )
        with torch.inference_mode():
            logits = self.model(meta, self.kv)
        return np.asarray(jlogits), logits.numpy()


def _extend_and_decode(pair, tol, adapters=None):
    """``adapters``: (active_adapters, slots of the two sequences), for a
    pair with toppings attached."""
    two = one = None
    if adapters is not None:
        two, one = adapters, (adapters[0], adapters[1][:1])
    rng = np.random.default_rng(1)
    V = pair.cfg.vocab_size
    pages = [np.arange(1, 13), np.arange(13, 25)]  # 48 tokens per sequence
    a = rng.integers(1, V, 30)
    b = rng.integers(1, V, 11)
    # extend: a fresh 20-token prompt next to a fresh 11-token one
    j, t = pair.step(ForwardMode.EXTEND, [(a[:20], 0, pages[0]), (b, 0, pages[1])], two)
    np.testing.assert_allclose(t, j, **tol)
    # extend after a cached prefix: the prompt's last 10 tokens as a chunk
    j, t = pair.step(ForwardMode.EXTEND, [(a[20:], 20, pages[0])], one)
    np.testing.assert_allclose(t, j, **tol)
    # teacher-forced decode steps on both sequences
    for s in range(4):
        nxt = rng.integers(1, V, 2)
        rows = [(nxt[:1], 30 + s, pages[0]), (nxt[1:], 11 + s, pages[1])]
        j, t = pair.step(ForwardMode.DECODE, rows, two)
        np.testing.assert_allclose(t, j, **tol)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_logits_match_jax(variant):
    _extend_and_decode(Pair(VARIANTS[variant]), TOL)


@pytest.mark.parametrize("quantization", ["w4a8", "w4a16"])
def test_quantized_logits_match_jax(quantization):
    """The quantized model over the same codes: the port's plain W4 GEMMs
    against the JAX package's CPU paths (``w4a8_matmul_xla``,
    ``w4a16_matmul_xla``) in every projection and the head, within the
    unquantized test's 1e-4. Readings, logits up to 3.3: W4A8 at most
    4.8e-7 apart (both sides draw the same int8 rows here; one x8 rounded
    the other way would move a logit by about ax * |w|, which this tolerance
    would catch), W4A16 at most 3.6e-6 (``w4a16_matmul_xla`` dequantizes
    before its dot, the port factors the scales out of it)."""
    _extend_and_decode(Pair(VARIANTS["tiny-debug"], quantization=quantization), TOL)


def test_inv_freq_matches_jax():
    """The port's copy of the rope frequency table, Llama-3 scaling included,
    is the JAX package's to the bit (that one is held to HF by
    tests/test_rope.py)."""
    for overrides in (VARIANTS["tiny-debug"], VARIANTS["llama3-rope"]):
        jcfg = jax_get_preset("tiny-debug", **overrides)
        cfg = get_preset("tiny-debug", **overrides)
        np.testing.assert_array_equal(compute_inv_freq(cfg), jax_inv_freq(jcfg))
    cfg = get_preset("llama-3.2-1b")
    np.testing.assert_array_equal(
        compute_inv_freq(cfg), jax_inv_freq(jax_get_preset("llama-3.2-1b"))
    )


def test_params_from_jax_both_orientations():
    """``[L, in, out]`` stacks and their ``[L, out, in]`` transposes load to
    the same state; a wrong orientation is refused by shape."""
    cfg = get_preset("tiny-debug", dtype="float32", **VARIANTS["llama3-rope"])
    jcfg = jax_get_preset("tiny-debug", dtype="float32", **VARIANTS["llama3-rope"])
    params = jax.tree.map(np.asarray, JaxLlama(jcfg).init_params(jax.random.PRNGKey(2), jnp.float32))
    state = params_from_jax(params, cfg)
    flipped = dict(params)
    flipped["layers"] = {
        k: np.swapaxes(v, 1, 2) if v.ndim == 3 else v for k, v in params["layers"].items()
    }
    state_t = params_from_jax(flipped, cfg, transposed=True)
    assert state.keys() == state_t.keys()
    for k in state:
        assert torch.equal(state[k], state_t[k]), k
    with pytest.raises(ValueError):
        params_from_jax(flipped, cfg)  # wq [L, out, in] read as [L, in, out]
