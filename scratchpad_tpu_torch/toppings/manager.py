"""Toppings: multi-tenant adapters served per request.

Counterpart of ``scratchpad_tpu/toppings/manager.py``. One base model serves
many fine-tunes, and each request names its own: rank-r LoRA adapters
(layer-stacked pools ``A[N, L, In, r_max]`` / ``B[N, L, r_max, Out]`` per
target projection) and full-rank int8 delta adapters (``dq[N, L, In, Out]``
with per-output-channel f32 scales ``ds[N, L, Out]``). Slot 0 of every pool
is the zero adapter, so a row with no topping adds nothing.

The host pools are numpy and are filled exactly as the JAX manager fills
them. The device pools are torch tensors on an explicit ``device``; unlike
the JAX manager, which uploads every pool whole at each registration, each
device pool is allocated once and a registration copies only the slot it
wrote into it, in place (at Llama-3.2-1B the delta pool alone is 7.8 GB, and
an old and a new copy would not fit beside the KV pool).
"""

from __future__ import annotations

import json
import os
from typing import Any, Optional

import numpy as np
import torch

from scratchpad_tpu_torch.ops.ldmm import delta_matmul_grouped, lora_grouped
from scratchpad_tpu_torch.utils import get_logger

logger = get_logger("toppings")

# distinct adapters per batch, including the zero slot (the scheduler caps
# admission to it). 8 keeps multi-tenant batches whole: at 4, a 4-adapter
# round-robin workload starved one adapter's requests in the JAX package
MAX_ACTIVE_TOPPINGS = 8

TARGET_MAP = {
    "q_proj": "wq",
    "k_proj": "wk",
    "v_proj": "wv",
    "o_proj": "wo",
    "gate_proj": "gate",
    "up_proj": "up",
    "down_proj": "down",
}


class ToppingsManager:
    def __init__(
        self,
        model_config,
        max_adapters: int = 8,
        max_rank: int = 16,
        dtype: torch.dtype = torch.bfloat16,
        device: torch.device | str = "cuda",
    ):
        cfg = model_config
        self.cfg = cfg
        self.max_adapters = max_adapters
        self.max_rank = max_rank
        self.dtype = dtype
        self.device = torch.device(device)
        L, H, D = cfg.num_hidden_layers, cfg.hidden_size, cfg.head_dim
        dims = {
            "wq": (H, cfg.num_attention_heads * D),
            "wk": (H, cfg.num_kv_heads * D),
            "wv": (H, cfg.num_kv_heads * D),
            "wo": (cfg.num_attention_heads * D, H),
            "gate": (H, cfg.intermediate_size),
            "up": (H, cfg.intermediate_size),
            "down": (cfg.intermediate_size, H),
        }
        # host pools; slot 0 stays zero (the no-op adapter)
        self._host_a = {
            t: np.zeros((max_adapters, L, din, max_rank), np.float32)
            for t, (din, dout) in dims.items()
        }
        self._host_b = {
            t: np.zeros((max_adapters, L, max_rank, dout), np.float32)
            for t, (din, dout) in dims.items()
        }
        self._dims = dims
        self._scaling = np.zeros(max_adapters, np.float32)
        # delta adapters: int8 values with per-output-channel scales, pools
        # allocated on the first delta registration
        self._host_dq: Optional[dict[str, np.ndarray]] = None
        self._host_ds: Optional[dict[str, np.ndarray]] = None
        self._delta_slots: set[int] = set()
        self.name_to_idx: dict[str, int] = {}
        self._next = 1
        dev = self.device
        self._device_pools: dict[str, Any] = {
            "a": {t: torch.zeros(v.shape, dtype=dtype, device=dev) for t, v in self._host_a.items()},
            "b": {t: torch.zeros(v.shape, dtype=dtype, device=dev) for t, v in self._host_b.items()},
            "scaling": torch.zeros(max_adapters, dtype=torch.float32, device=dev),
        }

    # ------------------------------------------------------------ registration

    def register(self, name: str, adapter_path: str) -> int:
        """Load a HF/peft LoRA checkpoint directory into a pool slot."""
        state, scaling = self.load_path(adapter_path)
        return self.register_state(name, state, scaling=scaling)

    def load_path(self, adapter_path: str):
        """(state dict, lora_alpha / r scaling) from a HF/peft checkpoint
        directory."""
        state = self._load_adapter_state(adapter_path)
        cfg_path = os.path.join(adapter_path, "adapter_config.json")
        alpha, r = 16.0, self.max_rank
        if os.path.exists(cfg_path):
            with open(cfg_path) as f:
                acfg = json.load(f)
            alpha = float(acfg.get("lora_alpha", 16))
            r = int(acfg.get("r", self.max_rank))
        return state, alpha / r

    def _slot(self, name: str) -> int:
        if name in self.name_to_idx:
            return self.name_to_idx[name]
        assert self._next < self.max_adapters, "topping pool full"
        idx = self._next
        self._next += 1
        self.name_to_idx[name] = idx
        return idx

    def register_state(
        self, name: str, state: dict[str, np.ndarray], scaling: float = 1.0
    ) -> int:
        idx = self._slot(name)
        loaded = 0
        for key, w in state.items():
            parsed = self._parse_key(key)
            if parsed is None:
                continue
            layer, target, which = parsed
            if which == "A":  # peft stores A as [r, in] -> [in, r]
                r = w.shape[0]
                assert r <= self.max_rank, f"rank {r} > max_rank {self.max_rank}"
                self._host_a[target][idx, layer, :, :r] = np.asarray(w, np.float32).T
            else:  # B: [out, r] -> [r, out]
                r = w.shape[1]
                self._host_b[target][idx, layer, :r, :] = np.asarray(w, np.float32).T
            loaded += 1
        self._scaling[idx] = scaling
        self._upload(idx)
        logger.info("registered topping %r -> slot %d (%d tensors)", name, idx, loaded)
        return idx

    def register_delta(
        self, name: str, state: dict[str, np.ndarray], scaling: float = 1.0
    ) -> int:
        """Register a full-rank weight-delta adapter (W_tuned - W_base per
        projection), stored int8 with per-output-channel scales.

        ``state`` maps HF weight names (model.layers.{i}.<proj>.weight) to
        delta matrices in HF [out, in] orientation.
        """
        if self._host_dq is None:
            self._alloc_delta_pools()
        idx = self._slot(name)
        loaded = 0
        for key, w in state.items():
            if not key.endswith(".weight") or ".layers." not in key:
                continue
            rest = key.split(".layers.", 1)[1]
            layer_s, tail = rest.split(".", 1)
            target = None
            for hf_name, t in TARGET_MAP.items():
                if tail.startswith(f"self_attn.{hf_name}.") or tail.startswith(f"mlp.{hf_name}."):
                    target = t
                    break
            if target is None:
                continue
            d = np.asarray(w, np.float32).T  # [in, out]
            amax = np.abs(d).max(axis=0)  # per output channel
            scale = np.where(amax > 0, amax / 127.0, 1.0)
            q = np.clip(np.round(d / scale), -127, 127).astype(np.int8)
            self._host_dq[target][idx, int(layer_s)] = q
            self._host_ds[target][idx, int(layer_s)] = scale
            loaded += 1
        self._delta_slots.add(idx)
        self._scaling[idx] = scaling
        self._upload(idx)
        logger.info("registered delta topping %r -> slot %d (%d tensors)", name, idx, loaded)
        return idx

    def _alloc_delta_pools(self) -> None:
        """The delta pools, host and device, all slots zero."""
        L = self.cfg.num_hidden_layers
        shapes = {t: (self.max_adapters, L, din, dout) for t, (din, dout) in self._dims.items()}
        self._host_dq = {t: np.zeros(s, np.int8) for t, s in shapes.items()}
        self._host_ds = {t: np.zeros(s[:2] + s[3:], np.float32) for t, s in shapes.items()}
        dev = self.device
        self._device_pools["dq"] = {
            t: torch.zeros(s, dtype=torch.int8, device=dev) for t, s in shapes.items()
        }
        self._device_pools["ds"] = {
            t: torch.zeros(s[:2] + s[3:], dtype=torch.float32, device=dev) for t, s in shapes.items()
        }
        self._device_pools["has_delta"] = torch.zeros(self.max_adapters, dtype=torch.int32, device=dev)

    def _upload(self, idx: int) -> None:
        """Copy slot ``idx`` of every host pool into the device pools, in
        place; the other slots and the pools' storage stay as they are."""
        pools = self._device_pools
        for t in self._dims:
            pools["a"][t][idx].copy_(torch.from_numpy(self._host_a[t][idx]))
            pools["b"][t][idx].copy_(torch.from_numpy(self._host_b[t][idx]))
            if self._host_dq is not None:
                pools["dq"][t][idx].copy_(torch.from_numpy(self._host_dq[t][idx]))
                pools["ds"][t][idx].copy_(torch.from_numpy(self._host_ds[t][idx]))
        pools["scaling"][idx] = float(self._scaling[idx])
        if self._host_dq is not None:
            pools["has_delta"][idx] = int(idx in self._delta_slots)
        if self.device.type == "cuda":
            free, total = torch.cuda.mem_get_info(self.device)
            logger.info(
                "topping pools: %.3f GiB on %s; %.2f of %.2f GiB free",
                self.device_bytes() / 2**30, self.device, free / 2**30, total / 2**30,
            )

    @staticmethod
    def _load_adapter_state(path: str) -> dict[str, np.ndarray]:
        from safetensors.numpy import load_file

        return load_file(os.path.join(path, "adapter_model.safetensors"))

    @staticmethod
    def _parse_key(key: str):
        """'...model.layers.{i}.self_attn.q_proj.lora_A.weight' ->
        (layer, target, 'A'|'B')."""
        if ".layers." not in key or ".lora_" not in key:
            return None
        try:
            rest = key.split(".layers.", 1)[1]
            layer_s, tail = rest.split(".", 1)
            for hf_name, target in TARGET_MAP.items():
                if f"{hf_name}.lora_A" in tail:
                    return int(layer_s), target, "A"
                if f"{hf_name}.lora_B" in tail:
                    return int(layer_s), target, "B"
        except (ValueError, IndexError):
            return None
        return None

    # ---------------------------------------------------------------- device

    def device_pools(self) -> dict[str, Any]:
        """{'a': {target: [N, L, In, r]}, 'b': {...}, 'scaling': f32[N]}, and
        with a delta adapter 'dq' (i8[N, L, In, Out]), 'ds' (f32[N, L, Out])
        and 'has_delta' (i32[N])."""
        return self._device_pools

    def device_bytes(self) -> int:
        def walk(v):
            if isinstance(v, dict):
                return sum(walk(x) for x in v.values())
            return v.numel() * v.element_size()

        return walk(self._device_pools)

    def lookup(self, name: Optional[str]) -> int:
        if not name:
            return 0
        if name not in self.name_to_idx:
            raise KeyError(f"unknown topping {name!r}")
        return self.name_to_idx[name]


def apply_topping(
    x: torch.Tensor,  # [T, In]
    base_out: torch.Tensor,  # [T, Out]
    pools: dict,
    target: str,
    layer_idx: int,
    active_adapters: torch.Tensor,  # i32[MAX_ACTIVE] pool slots (0 = zero adapter)
    token_slot: torch.Tensor,  # i32[T] position of each token's adapter
) -> torch.Tensor:
    """base_out + each token's OWN adapter contribution: the rank-r factors
    ride two batched einsums, and the int8 deltas of every slot one
    ``delta_matmul_grouped`` launch that adds them to their rows in place."""
    S = active_adapters.shape[0]
    scaling = pools["scaling"][active_adapters]  # f32[S]
    onehot = (
        token_slot[:, None] == torch.arange(1, S, dtype=token_slot.dtype, device=token_slot.device)
    ).float()  # [T, S-1]
    slot_scale = onehot * scaling[1:][None, :]
    sel = active_adapters[1:].long()
    A_act = pools["a"][target][sel, layer_idx]  # [S-1, In, r]
    B_act = pools["b"][target][sel, layer_idx]  # [S-1, r, Out]
    out = base_out + lora_grouped(x, A_act, B_act, slot_scale)
    if "dq" in pools:
        # ``out`` is a fresh tensor here: the kernel adds into it in place
        out = delta_matmul_grouped(
            out, x, pools["dq"][target], pools["ds"][target], layer_idx,
            active_adapters, pools["has_delta"], pools["scaling"], token_slot,
        )
    return out
