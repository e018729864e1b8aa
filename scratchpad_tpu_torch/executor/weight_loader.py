"""Weights for the port: HF checkpoints and the JAX package's parameters.

Counterpart of ``scratchpad_tpu/executor/weight_loader.py``. Besides reading
a local HF checkpoint, ``params_from_jax`` turns the JAX package's parameter
pytree — handed over as numpy arrays, so the port never imports JAX — into
the port's ``state_dict``; the parity tests build both sides from one state
this way. Quantized stacks (``layers_q``, ``lm_head_q``) are repacked into
the port's layout with ``pack_w4``, code for code. ``kv_cache_from_jax`` does
the same for a KV pool, so that both sides can attend over identical pages,
and ``toppings_from_jax`` for the adapter pools of a toppings manager.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Any

import numpy as np
import torch

from scratchpad_tpu_torch.config.model_config import ModelConfig
from scratchpad_tpu_torch.memory.kv_cache import SCALE_DTYPE, KVCache
from scratchpad_tpu_torch.ops.quant.w4_matmul import pack_w4
from scratchpad_tpu_torch.ops.quant.w4a16 import QuantizedLinear, concat_out
from scratchpad_tpu_torch.toppings.manager import ToppingsManager
from scratchpad_tpu_torch.utils import get_logger

logger = get_logger("weight_loader")

# JAX stacked-layer key -> (port module attribute, is an [in, out] matrix)
_JAX_LAYER_KEYS = {
    "wq": ("wq.weight", True),
    "wk": ("wk.weight", True),
    "wv": ("wv.weight", True),
    "wo": ("wo.weight", True),
    "gate": ("gate.weight", True),
    "up": ("up.weight", True),
    "down": ("down.weight", True),
    "bq": ("wq.bias", False),
    "bk": ("wk.bias", False),
    "bv": ("wv.bias", False),
    "input_norm": ("input_norm", False),
    "post_norm": ("post_norm", False),
}
# JAX quantized stack -> port module (separate gate and up stacks are fused)
_JAX_QUANT_KEYS = {
    "wq": "wq", "wk": "wk", "wv": "wv", "wo": "wo", "down": "down", "gate_up_f": "gate_up",
}


def load_hf_state(model_path: str) -> dict[str, torch.Tensor]:
    """Load a flat HF state dict (name -> tensor) from safetensors files."""
    from safetensors.torch import load_file

    files = sorted(glob.glob(os.path.join(model_path, "*.safetensors")))
    if not files:
        raise FileNotFoundError(f"no *.safetensors under {model_path}")
    index_path = os.path.join(model_path, "model.safetensors.index.json")
    if os.path.exists(index_path):
        with open(index_path) as f:
            index = json.load(f)
        files = sorted(
            {os.path.join(model_path, v) for v in index["weight_map"].values()}
        )
    state: dict[str, torch.Tensor] = {}
    for fp in files:
        state.update(load_file(fp))
    logger.info("loaded %d tensors from %d files", len(state), len(files))
    return state


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes arrays; numpy has no bf16
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))  # a writable copy


def params_from_jax(
    params_np: dict[str, Any], cfg: ModelConfig, transposed: bool = False
) -> dict[str, torch.Tensor]:
    """The JAX ``LlamaForCausalLM`` pytree (numpy leaves) as the port's
    ``state_dict``.

    JAX stores decoder matrices ``[L, in, out]``, or ``[L, out, in]`` when
    its runner transposed the stacks (``model.weights_transposed``, pass it
    as ``transposed``); square matrices make the two indistinguishable by
    shape, so the orientation is an argument and the shapes are checked.
    Quantized stacks come as objects with numpy ``q``, ``s``, ``z`` (nibble
    planes ``[L, In/2, Out]``, ``[L, G, Out]``), ``group_size`` and
    ``out_true``: the JAX ``QuantizedLinear`` after ``jax.tree.map(np.asarray)``."""
    H, D = cfg.hidden_size, cfg.head_dim
    Hq, Hkv, I = cfg.num_attention_heads, cfg.num_kv_heads, cfg.intermediate_size
    out_in = {  # nn.Linear orientation [out, in]
        "wq": (Hq * D, H), "wk": (Hkv * D, H), "wv": (Hkv * D, H),
        "wo": (H, Hq * D), "gate": (I, H), "up": (I, H), "down": (H, I),
    }
    state: dict[str, torch.Tensor] = {
        "embed.weight": _tensor(params_np["embed"]),
        "final_norm": _tensor(params_np["final_norm"]),
    }
    if "lm_head" in params_np and not cfg.tie_word_embeddings:
        state["lm_head.weight"] = _tensor(params_np["lm_head"])
    for key, stack in params_np["layers"].items():
        if key not in _JAX_LAYER_KEYS:
            raise KeyError(f"unmapped JAX layer parameter {key!r}")
        name, is_matrix = _JAX_LAYER_KEYS[key]
        stack = np.asarray(stack)
        if stack.shape[0] != cfg.num_hidden_layers:
            raise ValueError(f"{key}: {stack.shape[0]} layers, expected {cfg.num_hidden_layers}")
        for l in range(stack.shape[0]):
            w = stack[l]
            if is_matrix:
                if not transposed:
                    w = w.T
                if w.shape != out_in[key]:
                    raise ValueError(f"{key}: got {w.shape} after orientation, expected {out_in[key]}")
            state[f"layers.{l}.{name}"] = _tensor(w)
    layers_q = {
        k: QuantizedLinear(_tensor(v.q), _tensor(v.s), _tensor(v.z), v.group_size, v.out_true)
        for k, v in params_np.get("layers_q", {}).items()
    }
    state.update(quantized_layer_state(layers_q))
    if "lm_head_q" in params_np:
        ql = params_np["lm_head_q"]
        packed = pack_w4(
            QuantizedLinear(_tensor(ql.q), _tensor(ql.s), _tensor(ql.z), ql.group_size, ql.out_true)
        )
        for part, t in zip("qsz", packed):
            state[f"lm_head_q.{part}"] = t[0]
    return state


def quantized_layer_state(layers_q: dict[str, QuantizedLinear]) -> dict[str, torch.Tensor]:
    """The port's per-layer ``q``/``s``/``z`` entries of stacked quantized
    weights named as the JAX package's ``layers_q``. Separate gate and up
    stacks (a checkpoint import) are fused along Out into ``gate_up``."""
    layers_q = dict(layers_q)
    if "gate" in layers_q and "up" in layers_q:
        layers_q["gate_up_f"] = concat_out(layers_q.pop("gate"), layers_q.pop("up"))
    state = {}
    for key, ql in layers_q.items():
        if key not in _JAX_QUANT_KEYS:
            raise KeyError(f"unmapped quantized stack {key!r}")
        for l, qsz in enumerate(zip(*pack_w4(ql))):
            for part, t in zip("qsz", qsz):
                state[f"layers.{l}.{_JAX_QUANT_KEYS[key]}.{part}"] = t
    return state


def kv_cache_from_jax(kv: Any, scale: Any, num_layers: int, head_dim: int) -> KVCache:
    """The JAX package's unsharded 4-D int8 or fp8 KV pool (numpy arrays) as
    the port's ``KVCache``, code for code.

    ``kv [Pg, ps, 2 Hkv, Dp]`` holds K and V interleaved per head (``[k0, v0,
    k1, v1, ...]``), layer l's page p at global page ``l * Pg / num_layers +
    p``, head_dim padded to ``Dp`` lanes; ``scale [Pg, ps, SL]`` holds their
    bf16 scales in the same interleaved order in its first 2 Hkv lanes (one
    scale shard). The padded lanes are dropped and K, V and their scales
    de-interleaved."""
    kv = np.asarray(kv)
    Pg, ps, H2, Dp = kv.shape
    if Pg % num_layers or H2 % 2 or not 0 < head_dim <= Dp:
        raise ValueError(
            f"a [Pg, ps, 2 Hkv, Dp] pool of {num_layers} layers and head_dim <= Dp "
            f"expected, got {kv.shape} and head_dim {head_dim}"
        )
    pages, Hkv = Pg // num_layers, H2 // 2
    rows = kv.reshape(num_layers, pages, ps, Hkv, 2, Dp)[..., :head_dim]

    def half(i: int) -> torch.Tensor:
        a = np.ascontiguousarray(rows[..., i, :])
        if a.dtype.name == "float8_e4m3fn":  # ml_dtypes; numpy has no fp8
            return torch.from_numpy(a.view(np.uint8)).view(torch.float8_e4m3fn)
        return _tensor(a)

    sc = np.asarray(scale)
    if sc.shape[:2] != (Pg, ps) or sc.shape[2] < H2:
        raise ValueError(f"scale must be [{Pg}, {ps}, >= {H2}], got {sc.shape}")
    sc = sc[..., :H2].reshape(num_layers, pages, ps, Hkv, 2)
    return KVCache(
        k=half(0),
        v=half(1),
        k_scale=_tensor(sc[..., 0]).to(SCALE_DTYPE),
        v_scale=_tensor(sc[..., 1]).to(SCALE_DTYPE),
    )


def toppings_from_jax(jax_manager: Any, device) -> ToppingsManager:
    """The port's ``ToppingsManager`` holding the adapters of the JAX
    package's manager: its host pools (``_host_a``, ``_host_b``, ``_host_dq``,
    ``_host_ds``), scalings, delta slots and names, copied as they are, then
    uploaded to ``device`` slot by slot. The JAX manager's ``cfg`` supplies
    the same shape fields as the port's ``ModelConfig``."""
    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[np.dtype(jax_manager.dtype).name]
    m = ToppingsManager(
        jax_manager.cfg, max_adapters=jax_manager.max_adapters,
        max_rank=jax_manager.max_rank, dtype=dtype, device=device,
    )
    for t in m._dims:
        m._host_a[t][...] = jax_manager._host_a[t]
        m._host_b[t][...] = jax_manager._host_b[t]
    m._scaling[...] = jax_manager._scaling
    m.name_to_idx = dict(jax_manager.name_to_idx)
    m._next = jax_manager._next
    if jax_manager._host_dq is not None:
        m._alloc_delta_pools()
        for t in m._dims:
            m._host_dq[t][...] = jax_manager._host_dq[t]
            m._host_ds[t][...] = jax_manager._host_ds[t]
        m._delta_slots = set(jax_manager._delta_slots)
    for idx in range(m.max_adapters):
        m._upload(idx)
    return m
