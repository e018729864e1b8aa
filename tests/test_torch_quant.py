"""The port's 4-bit weights against the JAX package's, on the CPU.

- Quantization: the port's numpy copy gives the JAX package's codes, bf16
  scales and zeros, group size and padding, bit for bit; ``pack_w4`` holds
  the same codes as the JAX half planes and as ``to_4bit``'s 4-bit storage,
  and the JAX package's bf16 zeros (``to_4bit``'s f32 z - 8, plus 8).
- Activations: ``quantize_activations_plain`` is the JAX formula
  (``pallas_w4.py:453-460``) bit for bit, zero rows and .5 ties included.
- The plain GEMMs against the JAX references and the interpret-mode Pallas
  kernels, in f32, one layer at a time. Integer dots are exact on both
  sides, so only the f32 order of the group sums and of the zero
  correction differs: rtol = atol = 1e-5. ``w4a16_matmul_xla`` dequantizes
  the weight before its dot, which rounds otherwise: 2e-3, as
  ``tests/test_w4a8.py`` holds it.
- Checkpoint import: AWQ and GPTQ (v1, v2) tensors land on the same codes.
- The model's load path (``quantize_state``): the same dense weights give
  the JAX package's fused and head codes.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scratchpad_tpu.ops.quant import import_hf as jax_import_hf
from scratchpad_tpu.ops.quant.pallas_w4 import (
    to_4bit,
    w4_matmul_4bit,
    w4a8_matmul_pallas,
    w4a16_matmul_pallas,
)
from scratchpad_tpu.ops.quant.w4a16 import quantize_stacked as jax_quantize_stacked
from scratchpad_tpu.ops.quant.w4a16 import (
    quantize_model_params,
    slice_layer,
    w4a8_matmul_xla,
    w4a16_matmul_xla,
)
from scratchpad_tpu_torch.config.model_config import get_preset
from scratchpad_tpu_torch.models.llama import LlamaForCausalLM
from scratchpad_tpu_torch.ops.quant import import_hf
from scratchpad_tpu_torch.ops.quant.w4_matmul import (
    pack_w4,
    quantize_activations_plain,
    quantize_rows_int8,
    unpack_w4,
    w4a8_matmul,
    w4a8_matmul_plain,
    w4a16_matmul,
    w4a16_matmul_plain,
)
from scratchpad_tpu_torch.ops.quant.w4a16 import quantize_stacked
from scratchpad_tpu_torch.executor.weight_loader import quantized_layer_state
import torch_threads  # noqa: F401  (one torch thread a test process)

TOL = dict(rtol=1e-5, atol=1e-5)
# (L, In, Out) -> group: 128; 120 (half-plane rule, GPT-OSS); 100 (not a
# multiple of 8); 64 with a padded Out (out_true 200)
SHAPES = [(2, 256, 256), (2, 240, 256), (1, 200, 128), (1, 128, 200), (1, 256, 1000)]
GROUPS = {(2, 256, 256): 128, (2, 240, 256): 120, (1, 200, 128): 100, (1, 128, 200): 64,
          (1, 256, 1000): 128}


def _weights(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _f32(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("shape", SHAPES)
def test_quantize_stacked_matches_jax(shape):
    w = _weights(shape)
    jq = jax_quantize_stacked(w)
    pq = quantize_stacked(w)
    assert pq.group_size == jq.group_size == GROUPS[shape]
    assert pq.out_true == jq.out_true == (shape[2] if shape[2] % 128 else 0)
    np.testing.assert_array_equal(pq.q.numpy(), np.asarray(jq.q))
    assert pq.s.dtype == pq.z.dtype == torch.bfloat16 and jq.s.dtype == jnp.bfloat16
    np.testing.assert_array_equal(pq.s.float().numpy(), _f32(jq.s))
    np.testing.assert_array_equal(pq.z.float().numpy(), _f32(jq.z))


@pytest.mark.parametrize("shape", SHAPES + [(2, 3, 256, 128)])
def test_quantize_stacked_on_tensors_matches_jax(shape):
    """The engines quantize at load on their own device: a tensor takes the
    torch route, whose codes, scales and zeros are the JAX numpy ones bit
    for bit (zero and constant columns included)."""
    w = _weights(shape, seed=2)
    w[..., 0, :] = 0.0  # a row of zeros
    w[..., 3] = 0.5  # a constant column: a zero range, the 1e-8 floor
    jq = jax_quantize_stacked(w)
    pq = quantize_stacked(torch.from_numpy(w))
    assert pq.group_size == jq.group_size and pq.out_true == jq.out_true
    np.testing.assert_array_equal(pq.q.numpy(), np.asarray(jq.q))
    np.testing.assert_array_equal(pq.s.float().numpy(), _f32(jq.s))
    np.testing.assert_array_equal(pq.z.float().numpy(), _f32(jq.z))


@pytest.mark.parametrize("shape", SHAPES)
def test_pack_w4_holds_the_jax_codes(shape):
    jq = jax_quantize_stacked(_weights(shape, seed=1))
    L, In, _ = shape
    q, s, z = pack_w4(quantize_stacked(_weights(shape, seed=1)))
    assert q.shape == (L, jq.q.shape[-1], -(-In // 32) * 16)
    planes = np.asarray(jq.q)
    nibbles = np.concatenate([planes & 0xF, planes >> 4], axis=1)  # [L, In, N]
    np.testing.assert_array_equal(unpack_w4(q, In).numpy().astype(np.int32) + 8, nibbles)
    np.testing.assert_array_equal(z.float().numpy(), _f32(jq.z))  # the bf16 zero, as the JAX package holds it
    np.testing.assert_array_equal(s.float().numpy(), _f32(jq.s))
    if jq.group_size % 32 == 0:
        # byte (n, j) of the port = byte (j, n) of to_4bit's storage, whose
        # zero is z - 8 in f32
        q4 = to_4bit(jq)
        np.testing.assert_array_equal(q.transpose(1, 2).numpy()[:, : In // 2], np.asarray(q4.q4))
        np.testing.assert_array_equal(z.float().numpy() - 8.0, np.asarray(q4.z))


def test_activation_quantizer_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(7, 240)).astype(np.float32) * 3
    x[2] = 0.0  # a padding row: ax = 1, x8 = 0
    x[4, :5] = [127.0, 2.5, -3.5, 0.5, -0.5]  # amax 127, ax 1: exact .5 ties
    x[5] *= 1e-3
    xj = jnp.asarray(x)
    # pallas_w4.py:453-460
    amax = jnp.max(jnp.abs(xj.astype(jnp.float32)), axis=1, keepdims=True)
    ax = jnp.where(amax == 0.0, 1.0, amax / 127.0)
    x8 = jnp.clip(jnp.round(xj.astype(jnp.float32) / ax), -127, 127).astype(jnp.int8)
    gsum = jnp.sum(x8.reshape(7, 2, 120).astype(jnp.int32), axis=2).astype(jnp.float32)
    px8, pax, pgsum = quantize_activations_plain(torch.from_numpy(x), 120)
    assert px8.shape == (7, 256) and not px8[:, 240:].any()  # rows padded to 32
    np.testing.assert_array_equal(px8[:, :240].numpy(), np.asarray(x8))
    np.testing.assert_array_equal(pax.numpy(), np.asarray(ax))
    np.testing.assert_array_equal(pgsum.numpy(), np.asarray(gsum))
    assert px8[4, :5].tolist() == [127, 2, -4, 0, -0]
    # the wrapper takes the plain version for a CPU tensor
    for a, b in zip(quantize_rows_int8(torch.from_numpy(x), 120), (px8, pax, pgsum)):
        assert torch.equal(a, b)


def _pair(shape, seed):
    """The same weights quantized by both packages, and their inputs. The
    weights have the models' scale, 1/sqrt(In), so y is O(1): the u8
    kernels' unsigned form cancels terms 8 * xg_sum * s larger than y, and
    their own f32 rounding grows with those terms."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=shape).astype(np.float32) / np.sqrt(shape[1])
    x = rng.normal(size=(8, shape[1])).astype(np.float32)
    x[3] = 0.0
    return jax_quantize_stacked(w), pack_w4(quantize_stacked(w)), x


@pytest.mark.parametrize("shape", SHAPES)
def test_w4a8_plain_matches_jax(shape):
    jq, (q, s, z), x = _pair(shape, seed=3)
    g = jq.group_size
    xt = torch.from_numpy(x)
    for l in range(shape[0]):
        x8, ax, gsum = quantize_activations_plain(xt, g)
        out = w4a8_matmul_plain(x8, ax, gsum, q[l], s[l], z[l], g, jq.out_features).numpy()
        assert torch.equal(
            w4a8_matmul(x8, ax, gsum, q[l], s[l], z[l], g, jq.out_features), torch.from_numpy(out)
        )
        np.testing.assert_allclose(out, np.asarray(w4a8_matmul_xla(jnp.asarray(x), slice_layer(jq, l))), **TOL)
        pallas = (
            w4_matmul_4bit(jnp.asarray(x), to_4bit(jq), jnp.int32(l), a8=True, out_block=128)
            if g % 32 == 0
            else w4a8_matmul_pallas(jnp.asarray(x), jq, jnp.int32(l), out_block=128)
        )
        np.testing.assert_allclose(out, np.asarray(pallas), **TOL)
        assert not out[3].any()


@pytest.mark.parametrize("shape", SHAPES)
def test_w4a16_plain_matches_jax(shape):
    jq, (q, s, z), x = _pair(shape, seed=4)
    g = jq.group_size
    xt = torch.from_numpy(x)
    for l in range(shape[0]):
        out = w4a16_matmul_plain(xt, q[l], s[l], z[l], g, jq.out_features).numpy()
        assert torch.equal(w4a16_matmul(xt, q[l], s[l], z[l], g, jq.out_features), torch.from_numpy(out))
        pallas = (
            w4_matmul_4bit(jnp.asarray(x), to_4bit(jq), jnp.int32(l), a8=False, out_block=128)
            if g % 32 == 0
            else w4a16_matmul_pallas(jnp.asarray(x), jq, jnp.int32(l), out_block=128)
        )
        np.testing.assert_allclose(out, np.asarray(pallas), **TOL)
        xla = w4a16_matmul_xla(jnp.asarray(x), slice_layer(jq, l))
        np.testing.assert_allclose(out, np.asarray(xla), rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("method", ["awq", "gptq", "gptq_v2"])
def test_checkpoint_import_matches_jax(method):
    """AutoAWQ / AutoGPTQ tensors of two layers (g 64; GPTQ v1 zeros up to
    16) import to the JAX package's codes, and fuse gate|up in place."""
    rng = np.random.default_rng(5)
    L, In, Out, g = 2, 128, 64, 64
    zmax = 17 if method == "gptq" else 16
    quant = {}
    for l in range(L):
        for mod in ("self_attn.q_proj", "mlp.gate_proj", "mlp.up_proj"):
            q = rng.integers(0, 16, (In, Out)).astype(np.uint8)
            z = rng.integers(1 if method == "gptq" else 0, zmax, (In // g, Out)).astype(np.float32)
            s = rng.uniform(0.01, 0.1, (In // g, Out)).astype(np.float16)
            if method == "awq":
                qw, qz, sc = jax_import_hf.pack_awq(q, z, s)
            else:
                qw, qz, sc = jax_import_hf.pack_gptq(q, z, s, v2=method == "gptq_v2")
            name = f"model.layers.{l}.{mod}"
            quant.update({f"{name}.qweight": qw, f"{name}.qzeros": qz, f"{name}.scales": sc})
    kind = "awq" if method == "awq" else "gptq"
    v2 = method == "gptq_v2"
    ours = import_hf.convert_quantized_layers(quant, L, kind, gptq_v2=v2)
    theirs = jax_import_hf.convert_quantized_layers(quant, L, kind, jnp.bfloat16, gptq_v2=v2)
    assert ours.keys() == theirs.keys() == {"wq", "gate", "up"}
    for key in ours:
        np.testing.assert_array_equal(ours[key].q.numpy(), np.asarray(theirs[key].q))
        np.testing.assert_array_equal(ours[key].z.float().numpy(), _f32(theirs[key].z))
        np.testing.assert_array_equal(ours[key].s.float().numpy(), _f32(theirs[key].s))
    state = quantized_layer_state(ours)
    assert state["layers.1.gate_up.q"].shape == (2 * Out, In // 2)
    gate_codes = unpack_w4(state["layers.1.gate_up.q"], In)[:, :Out]
    np.testing.assert_array_equal(gate_codes.numpy() + 8, np.concatenate(
        [np.asarray(theirs["gate"].q[1]) & 0xF, np.asarray(theirs["gate"].q[1]) >> 4]
    ))


@pytest.mark.parametrize("tied", [True, False])
def test_quantize_state_matches_jax(tied):
    """The load path of every random-weight or dense W4 engine: the port's
    ``[out, in]`` weights are transposed, gate|up fused gate first, and the
    head quantized from ``embed.T`` (tied) or ``lm_head`` (untied). The
    JAX package, given the same weights as ``[L, in, out]`` stacks, gives
    the same codes. tiny-debug's wq and wo are square, so an orientation
    error would keep the shapes and change the codes."""
    cfg = dataclasses.replace(get_preset("tiny-debug"), tie_word_embeddings=tied)
    dense = LlamaForCausalLM(cfg, "cpu", torch.float32).requires_grad_(False)
    dense.init_random_(torch.Generator().manual_seed(6))
    model = LlamaForCausalLM(cfg, "cpu", torch.float32, quantization="w4a8", quantize_lm_head=True)
    model.load_state_dict(model.quantize_state(dense.state_dict()))

    targets = ("wq", "wk", "wv", "wo", "gate", "up", "down")
    layers = {
        t: np.stack([getattr(layer, t).weight.numpy().T for layer in dense.layers])
        for t in targets
    }
    stacks = quantize_model_params({"layers": layers}, fuse_gate_up=True)["layers_q"]
    assert set(stacks) == {"wq", "wk", "wv", "wo", "gate_up_f", "down"}
    stacks["gate_up"] = stacks.pop("gate_up_f")
    for l, layer in enumerate(model.layers):
        for name, ql in stacks.items():
            assert_same_codes(getattr(layer, name), ql, l)
    head = (dense.embed if tied else dense.lm_head).weight.numpy()
    assert_same_codes(model.lm_head_q, jax_quantize_stacked(head.T[None]), 0)
    assert model.lm_head is None
    assert torch.equal(model.embed.weight, dense.embed.weight)  # kept for lookups


def assert_same_codes(lin, ql, l):
    """A ``QuantLinear``'s buffers hold layer ``l`` of the JAX package's
    half-plane stack ``ql``: codes, bf16 scales, zeros and group size."""
    planes = np.asarray(ql.q[l])
    nibbles = np.concatenate([planes & 0xF, planes >> 4])  # [In, N]
    assert lin.group_size == ql.group_size
    np.testing.assert_array_equal(unpack_w4(lin.q, lin.in_features).numpy() + 8, nibbles)
    np.testing.assert_array_equal(lin.s.float().numpy(), np.asarray(ql.s[l], np.float32))
    np.testing.assert_array_equal(lin.z.float().numpy(), np.asarray(ql.z[l], np.float32))


def test_w4_launch_counts_by_group_size():
    """The W4 GEMM wrappers count each launch in ``launches`` and by group
    size in ``group_launches``; ``reset_launch_counts`` clears both."""
    from scratchpad_tpu_torch.ops import reset_launch_counts
    from scratchpad_tpu_torch.ops.quant.w4_matmul import count_launch, w4a8_matmul, w4a16_matmul

    reset_launch_counts()
    for g in (120, 120, 128):
        count_launch(w4a8_matmul, g)
    count_launch(w4a16_matmul, 120)
    assert (w4a8_matmul.launches, w4a8_matmul.group_launches) == (3, {120: 2, 128: 1})
    assert (w4a16_matmul.launches, w4a16_matmul.group_launches) == (1, {120: 1})
    reset_launch_counts()
    assert w4a8_matmul.launches == w4a16_matmul.launches == 0
    assert w4a8_matmul.group_launches == w4a16_matmul.group_launches == {}
