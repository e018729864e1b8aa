"""Weights for the port: HF checkpoints and the JAX package's parameters.

Counterpart of ``scratchpad_tpu/executor/weight_loader.py``. Besides reading
a local HF checkpoint, ``params_from_jax`` turns the JAX package's parameter
pytree — handed over as numpy arrays, so the port never imports JAX — into
the port's ``state_dict``; the parity tests build both sides from one state
this way. Quantized stacks (``layers_q``, ``lm_head_q``) are repacked into
the port's layout with ``pack_w4``, code for code. ``kv_cache_from_jax`` does
the same for a KV pool, so that both sides can attend over identical pages,
and ``toppings_from_jax`` for the adapter pools of a toppings manager.
``shard_state`` cuts a single-device state into a tensor-parallel rank's.
"""

from __future__ import annotations

import dataclasses
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
    # Qwen3 and Gemma 3
    "q_norm": ("q_norm", False),
    "k_norm": ("k_norm", False),
    # Apertus: its two norms' names, and xIELU's two f32 scalars a layer
    "attn_norm": ("attn_norm", False),
    "ffw_norm": ("ffw_norm", False),
    "alpha_p": ("alpha_p", False),
    "alpha_n": ("alpha_n", False),
    # Gemma's other three norms a layer
    "post_attn_norm": ("post_attn_norm", False),
    "pre_ffw_norm": ("pre_ffw_norm", False),
    "post_ffw_norm": ("post_ffw_norm", False),
}
# the MoE families' own layer keys (Mixtral, Qwen3-MoE, GPT-OSS, Llama-4),
# as _JAX_LAYER_KEYS; their expert stacks [E, In, Out] (gate_up, down, w1,
# w2, w3) keep that orientation in the port
_JAX_MOE_KEYS = {
    "router": ("router.weight", True),
    "router_w": ("router.weight", True),
    "router_b": ("router.bias", False),
    "bo": ("wo.bias", False),
    "sinks": ("sinks", False),
    "gate_up": ("gate_up", False),
    "gate_up_b": ("gate_up_b", False),
    "down": ("down", False),
    "down_b": ("down_b", False),
    "w1": ("w1", False),
    "w2": ("w2", False),
    "w3": ("w3", False),
    # Llama-4: the shared expert, and a dense layer's down (beside the MoE
    # layers' expert stack "down")
    "s_gate": ("s_gate.weight", True),
    "s_up": ("s_up.weight", True),
    "s_down": ("s_down.weight", True),
    "down_d": ("down_d.weight", True),
}
# DeepSeek's layer keys (both groups, ``layers_dense`` and ``layers``):
# the JAX [in, out] matrices, transposed into nn.Linear's [out, in]; the
# rest keep their orientation (w_uk [Hq, dn, r], w_uv [Hq, r, dv], the
# expert stacks [E, In, Out], the f32 router_bias [E])
_JAX_DEEPSEEK_MATRICES = {
    "wq": "wq.weight", "wq_a": "wq_a.weight", "wq_b": "wq_b.weight", "wkv_a": "wkv_a.weight",
    "wo": "wo.weight", "gate": "gate.weight", "up": "up.weight", "down": "down.weight",
    "router": "router.weight", "shared_gate": "shared_gate.weight",
    "shared_up": "shared_up.weight", "shared_down": "shared_down.weight",
}
_JAX_DEEPSEEK_OTHERS = (
    "input_norm", "post_norm", "q_norm", "kv_norm", "w_uk", "w_uv", "router_bias", "w1", "w2", "w3",
)
# JAX quantized stack -> port module (separate gate and up stacks are fused)
_JAX_QUANT_KEYS = {
    "wq": "wq", "wk": "wk", "wv": "wv", "wo": "wo", "down": "down", "gate_up_f": "gate_up",
}
# the quantized expert stacks of a MoE model, [L * E, ...] with (layer l,
# expert e) at l * E + e; in the port one QuantLinear an expert, "{key}.{e}"
_JAX_QUANT_EXPERT_KEYS = ("gate_up", "down", "w1", "w2", "w3")


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
    if a.dtype.name == "float8_e4m3fn":  # the codes' bits, as they are
        return torch.from_numpy(np.array(a).view(np.uint8)).view(torch.float8_e4m3fn)
    return torch.from_numpy(np.array(a))  # a writable copy


def _flat_state(tree: Any, prefix: str) -> dict[str, torch.Tensor]:
    """A nested dict of numpy leaves as ``state_dict`` entries, the keys
    joined with dots under ``prefix`` (the vision models' ``vision`` and
    ``projector`` pytrees keep the JAX names in the port)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_state(v, f"{prefix}.{k}"))
        return out
    return {prefix: _tensor(tree)}


def _fp8_layer_state(layers_q: dict, num_experts: int) -> dict[str, torch.Tensor]:
    """The JAX package's ``Fp8Linear`` stacks (numpy ``w8 [L, In, Out]``,
    ``s [L, Out]``; expert stacks ``[L * E, ...]``, (layer l, expert e) at l *
    E + e) as the port's ``Fp8Linear`` and ``Fp8ExpertStack`` buffers."""
    state = {}
    for key, fl in layers_q.items():
        w8, sc = _tensor(fl.w8), _tensor(fl.s)
        if num_experts > 0 and key in _JAX_QUANT_EXPERT_KEYS:
            E = num_experts
            w8, sc = w8.view(-1, E, *w8.shape[1:]), sc.view(-1, E, sc.shape[-1])
        for l in range(w8.shape[0]):
            state[f"layers.{l}.{key}.w8"] = w8[l].contiguous()
            state[f"layers.{l}.{key}.s"] = sc[l].contiguous()
    return state


def params_from_jax(
    params_np: dict[str, Any], cfg: ModelConfig, transposed: bool = False
) -> dict[str, torch.Tensor]:
    """The JAX ``LlamaForCausalLM`` pytree (numpy leaves) as the port's
    ``state_dict``; Qwen2 (q, k, v biases), Qwen3 (``q_norm``, ``k_norm``),
    Phi-3, Apertus and Gemma (four norms a layer, a tied head) pytrees
    alike, and those of the MoE families (``cfg.num_experts > 0``: Mixtral,
    Qwen3-MoE, GPT-OSS), whose expert stacks ``[L, E, In, Out]`` keep their
    orientation in the port; DeepSeek's (``cfg.is_mla``) two layer groups go
    through ``_deepseek_state_from_jax``. ``layers`` is a dict of ``[L, ...]``
    stacks, or (Llama-4, whose dense and MoE layers differ) a list of L dicts of one
    layer's arrays; a dense layer's MLP is ``intermediate_size_mlp`` wide
    where the config sets it.

    JAX stores decoder matrices ``[L, in, out]``, or ``[L, out, in]`` when
    its runner transposed the stacks (``model.weights_transposed``, pass it
    as ``transposed``); square matrices make the two indistinguishable by
    shape, so the orientation is an argument and the shapes are checked.
    Quantized stacks come as objects with numpy ``q``, ``s``, ``z`` (nibble
    planes ``[L, In/2, Out]``, ``[L, G, Out]``), ``group_size`` and
    ``out_true``: the JAX ``QuantizedLinear`` after ``jax.tree.map(np.asarray)``;
    or, for fp8, with ``w8`` and ``s`` (the JAX ``Fp8Linear``). The vision
    models' ``vision`` and ``projector`` pytrees keep their JAX names
    (``vision.layers.wq``, Qwen2-VL's ``vision.blocks.qkv_w`` and
    ``vision.merger.w1``, Mllama's ``vision.local.wq``), as do Mllama's
    stacked ``cross_layers``; its ``layers`` are its self layers."""
    if cfg.is_mla:
        if transposed:
            raise ValueError("DeepSeek's JAX stacks are never transposed by its runner")
        return _deepseek_state_from_jax(params_np, cfg)
    H, D = cfg.hidden_size, cfg.head_dim
    Hq, Hkv, I = cfg.num_attention_heads, cfg.num_kv_heads, cfg.intermediate_size
    E, Ie = cfg.num_experts, cfg.moe_intermediate_size or cfg.intermediate_size
    Im = cfg.intermediate_size_mlp or I
    out_in = {  # nn.Linear orientation [out, in]
        "wq": (Hq * D, H), "wk": (Hkv * D, H), "wv": (Hkv * D, H),
        "wo": (H, Hq * D), "gate": (Im, H), "up": (Im, H), "down": (H, I),
        "router": (E, H), "router_w": (E, H),
        "s_gate": (I, H), "s_up": (I, H), "s_down": (H, I), "down_d": (H, Im),
    }
    in_out = {  # the expert stacks [E, In, Out]
        "gate_up": (E, H, 2 * Ie), "down": (E, Ie, H),
        "w1": (E, H, Ie), "w3": (E, H, Ie), "w2": (E, Ie, H),
    }
    layer_keys = {**_JAX_LAYER_KEYS, **_JAX_MOE_KEYS} if E > 0 else _JAX_LAYER_KEYS
    state: dict[str, torch.Tensor] = {
        "embed.weight": _tensor(params_np["embed"]),
        "final_norm": _tensor(params_np["final_norm"]),
    }
    if "lm_head" in params_np and not cfg.tie_word_embeddings:
        state["lm_head.weight"] = _tensor(params_np["lm_head"])
    # Mllama stacks its self layers alone (its cross layers: ``cross_layers``)
    L = cfg.num_hidden_layers - sum(i < cfg.num_hidden_layers for i in cfg.cross_attention_layers or [])
    layers = params_np["layers"]
    if isinstance(layers, dict):
        stacks = {key: np.asarray(stack) for key, stack in layers.items()}
        for key, stack in stacks.items():
            if stack.shape[0] != L:
                raise ValueError(f"{key}: {stack.shape[0]} layers, expected {L}")
        items = [(key, l, stack[l]) for key, stack in stacks.items() for l in range(L)]
    else:
        if len(layers) != L:
            raise ValueError(f"{len(layers)} layers, expected {L}")
        items = [(key, l, np.asarray(w)) for l, lp in enumerate(layers) for key, w in lp.items()]
    for key, l, w in items:
        if key not in layer_keys:
            raise KeyError(f"unmapped JAX layer parameter {key!r}")
        name, is_matrix = layer_keys[key]
        if E > 0 and key in in_out:
            if transposed:
                w = np.swapaxes(w, -1, -2)
            if w.shape != in_out[key]:
                raise ValueError(f"{key}: got {w.shape} after orientation, expected {in_out[key]}")
        elif is_matrix:
            if not transposed:
                w = w.T
            if w.shape != out_in[key]:
                raise ValueError(f"{key}: got {w.shape} after orientation, expected {out_in[key]}")
        state[f"layers.{l}.{name}"] = _tensor(w)
    raw_q = params_np.get("layers_q", {})
    fp8 = {k: v for k, v in raw_q.items() if hasattr(v, "w8")}
    state.update(_fp8_layer_state(fp8, E))
    layers_q = {
        k: QuantizedLinear(_tensor(v.q), _tensor(v.s), _tensor(v.z), v.group_size, v.out_true)
        for k, v in raw_q.items()
        if k not in fp8
    }
    state.update(quantized_layer_state(layers_q, E))
    for tree in ("vision", "projector", "cross_layers"):
        if tree in params_np:
            state.update(_flat_state(params_np[tree], tree))
    if "lm_head_q" in params_np:
        ql = params_np["lm_head_q"]
        packed = pack_w4(
            QuantizedLinear(_tensor(ql.q), _tensor(ql.s), _tensor(ql.z), ql.group_size, ql.out_true)
        )
        for part, t in zip("qsz", packed):
            state[f"lm_head_q.{part}"] = t[0]
    return state


def shard_state(
    state: dict[str, torch.Tensor], rank: int, tp: int, family: str = "llama", out_true=None
) -> dict[str, torch.Tensor]:
    """Rank ``rank``'s shards of a ``family`` model's ``state_dict`` at
    tensor parallel size ``tp`` (a key of ``parallel.TP_LAYOUTS``, the
    model class's ``tp_family``): the counterpart of the JAX
    ``place_params`` with the family's ``param_specs``, by
    ``parallel.shard_tensor``. For the Llama family (``models/llama.py
    :116-143``): q, k, v, gate, up and the q, k, v biases by output column
    (whole heads), o and down by input row, the embedding and an untied head
    by vocabulary row (V padded up to a multiple of ``tp``), the norms
    replicated; the other families as their tables say. Quantized weights
    (W4's ``q``, ``s``, ``z``, fp8's ``w8``, ``s``) are cut in the packed
    layout (``parallel.cut_w4``, ``cut_fp8``); ``out_true`` maps a W4
    module's name to its single-device real width, where its stored width
    is padded (``QuantizedLinear.out_true``; absent: every stored column is
    real)."""
    from scratchpad_tpu_torch.parallel import shard_tensor

    widths = out_true or {}
    return {
        name: shard_tensor(name, t, rank, tp, family, widths.get(name.rsplit(".", 1)[0], 0))
        for name, t in state.items()
    }


def w4_real_widths(model, size: int) -> dict[str, int]:
    """``shard_state``'s ``out_true`` for a tensor-parallel rank's ``model``
    at group size ``size``: each column-split ``QuantLinear``'s
    single-device real width, the rank's width times ``size``."""
    from scratchpad_tpu_torch.models.common import QuantLinear
    from scratchpad_tpu_torch.parallel import split_of

    return {
        prefix: m.out_features * size
        for prefix, m in model.named_modules()
        if isinstance(m, QuantLinear) and split_of(f"{prefix}.q", model.tp_family)[1] in ("column", "halves")
    }


def eagle_params_from_jax(params_np: dict[str, Any], cfg: ModelConfig) -> dict[str, torch.Tensor]:
    """The JAX ``EagleRunner.params`` (numpy leaves: ``layers``, stacks of
    one layer, ``fc`` [2H, H] and ``fc_b`` or None) as the ``state_dict`` of
    the port's ``EagleRunner``, for a target of config ``cfg``."""
    one = dataclasses.replace(cfg, num_hidden_layers=1)
    H = cfg.hidden_size
    stub = {"embed": np.zeros((1, H), np.float32), "final_norm": np.ones(H, np.float32)}
    state = {
        k: v
        for k, v in params_from_jax({**stub, "layers": params_np["layers"]}, one).items()
        if k.startswith("layers.")
    }
    state["fc.weight"] = _tensor(np.asarray(params_np["fc"]).T)
    if params_np.get("fc_b") is not None:
        state["fc.bias"] = _tensor(params_np["fc_b"])
    return state


def _deepseek_state_from_jax(params_np: dict[str, Any], cfg: ModelConfig) -> dict[str, torch.Tensor]:
    """The JAX DeepSeek pytree: its dense layers' stacks (``layers_dense``,
    the first ``first_k_dense_replace`` layers) and its MoE layers' stacks
    (``layers``, the rest), each ``[L_group, ...]``, as the port's
    ``state_dict``; every JAX matrix's shape is checked against the port's
    [out, in] after the transpose."""
    H, Hq, E = cfg.hidden_size, cfg.num_attention_heads, cfg.num_experts
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    r, qr, I = cfg.kv_lora_rank, cfg.q_lora_rank, cfg.intermediate_size
    Is = (cfg.moe_intermediate_size or I) * max(cfg.n_shared_experts, 1)
    out_in = {
        "wq": (Hq * (dn + dr), H), "wq_a": (qr, H), "wq_b": (Hq * (dn + dr), qr),
        "wkv_a": (r + dr, H), "wo": (H, Hq * dv), "gate": (I, H), "up": (I, H), "down": (H, I),
        "router": (E, H), "shared_gate": (Is, H), "shared_up": (Is, H), "shared_down": (H, Is),
    }
    state: dict[str, torch.Tensor] = {
        "embed.weight": _tensor(params_np["embed"]),
        "final_norm": _tensor(params_np["final_norm"]),
    }
    if "lm_head" in params_np and not cfg.tie_word_embeddings:
        state["lm_head.weight"] = _tensor(params_np["lm_head"])
    first = 0
    for group in ("layers_dense", "layers"):
        stacks = {k: np.asarray(v) for k, v in params_np.get(group, {}).items()}
        n = {a.shape[0] for a in stacks.values()}
        if len(n) > 1:
            raise ValueError(f"{group}: stacks of {sorted(n)} layers")
        for key, stack in stacks.items():
            for i, w in enumerate(stack):
                if key in _JAX_DEEPSEEK_MATRICES:
                    w = w.T
                    if w.shape != out_in[key]:
                        raise ValueError(
                            f"{group}.{key}: got {w.shape} after the transpose, expected {out_in[key]}"
                        )
                    name = _JAX_DEEPSEEK_MATRICES[key]
                elif key in _JAX_DEEPSEEK_OTHERS:
                    name = key
                else:
                    raise KeyError(f"unmapped JAX DeepSeek parameter {group}.{key}")
                state[f"layers.{first + i}.{name}"] = _tensor(w)
        first += n.pop() if n else 0
    if first != cfg.num_hidden_layers:
        raise ValueError(f"{first} layers, expected {cfg.num_hidden_layers}")
    return state


def quantized_layer_state(
    layers_q: dict[str, QuantizedLinear], num_experts: int = 0
) -> dict[str, torch.Tensor]:
    """The port's per-layer ``q``/``s``/``z`` entries of stacked quantized
    weights named as the JAX package's ``layers_q``. Separate gate and up
    stacks (a checkpoint import) are fused along Out into ``gate_up``. With
    ``num_experts`` E > 0, the expert stacks (``gate_up``, ``down``, ``w1``,
    ``w2``, ``w3``) hold L * E slices, (layer l, expert e) at the flat index
    l * E + e (``quantize_stacked``'s 4-D rule), and go to ``{key}.{e}`` of
    layer l."""
    layers_q = dict(layers_q)
    if "gate" in layers_q and "up" in layers_q:
        layers_q["gate_up_f"] = concat_out(layers_q.pop("gate"), layers_q.pop("up"))
    state = {}
    for key, ql in layers_q.items():
        experts = num_experts > 0 and key in _JAX_QUANT_EXPERT_KEYS
        if not experts and key not in _JAX_QUANT_KEYS:
            raise KeyError(f"unmapped quantized stack {key!r}")
        if experts and ql.q.shape[0] % num_experts:
            raise ValueError(f"{key}: {ql.q.shape[0]} slices are not layers x {num_experts} experts")
        for i, qsz in enumerate(zip(*pack_w4(ql))):
            if experts:
                l, e = divmod(i, num_experts)
                name = f"layers.{l}.{key}.{e}"
            else:
                name = f"layers.{i}.{_JAX_QUANT_KEYS[key]}"
            for part, t in zip("qsz", qsz):
                state[f"{name}.{part}"] = t
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
