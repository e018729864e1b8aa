"""Parameter offload: decoder layers held in host memory, streamed to the
card a group at a time.

Counterpart of the JAX runner's ``_init_param_offload`` and
``_offload_forward_and_sample`` (``executor/model_runner.py:1801-1892``).
The decoder layers are split into ``param_offload_groups`` groups (at
least two) and their tensors move to host memory, pinned where the model
lives on the card. A forward copies group g + 1 to the card on a side
stream while group g computes; an event orders each group's compute after
its copy, so the card holds at most two groups of layers at a time. The
embedding, the final norm and the head stay resident. Llama-family
forwards only (``LlamaForCausalLM.run_layers``), as in the JAX package.

An offloaded tensor leaves its module's parameters and buffers and
becomes a plain attribute that is set for the length of its group's
forward, so ``model.state_dict()`` lists only what stays on the card;
``state_dict`` here lists both.
"""

from __future__ import annotations

import numpy as np
import torch

from scratchpad_tpu_torch.executor.forward_meta import ForwardMeta
from scratchpad_tpu_torch.memory.kv_cache import KVCache
from scratchpad_tpu_torch.models.llama import LlamaForCausalLM
from scratchpad_tpu_torch.utils import get_logger

logger = get_logger("param_offload")


def _leaves(layer: torch.nn.Module, prefix: str):
    """(state_dict name, module, attribute) of each tensor of ``layer``."""
    for path, mod in layer.named_modules():
        for table in (mod._parameters, mod._buffers):
            for n, t in table.items():
                if t is not None:
                    yield prefix + (f"{path}." if path else "") + n, mod, n


class ParamOffload:
    def __init__(self, model: torch.nn.Module, groups: int):
        if not isinstance(model, LlamaForCausalLM) or type(model).forward is not LlamaForCausalLM.forward:
            raise ValueError(
                f"enable_param_offload supports the Llama-family forward only, not "
                f"{type(model).__name__}"
            )
        self.model = model
        self.device = model.final_norm.device
        self.cuda = self.device.type == "cuda"
        L = len(model.layers)
        bounds = np.linspace(0, L, max(2, groups) + 1).astype(int)
        self.groups = [(int(s), int(e)) for s, e in zip(bounds[:-1], bounds[1:]) if s < e]
        # per layer: [(name, module, attribute, host tensor)]
        self.layers: list[list] = []
        host_bytes = 0
        for l, layer in enumerate(model.layers):
            entries = []
            for name, mod, attr in list(_leaves(layer, f"layers.{l}.")):
                t = mod._parameters.pop(attr, None)
                if t is None:
                    t = mod._buffers.pop(attr)
                host = t.detach().to("cpu")
                if self.cuda:
                    host = host.pin_memory()
                host_bytes += host.numel() * host.element_size()
                mod.__dict__[attr] = None
                entries.append((name, mod, attr, host))
            self.layers.append(entries)
        if self.cuda:
            torch.cuda.empty_cache()
            self.copy_stream = torch.cuda.Stream(self.device)
        logger.info(
            "param offload: %d decoder groups, %.2f GiB in host memory",
            len(self.groups), host_bytes / 2**30,
        )

    def _fetch(self, g: int):
        """Start group g's copy to the device: (tensors, event)."""
        s, e = self.groups[g]
        hosts = [h for l in range(s, e) for (_, _, _, h) in self.layers[l]]
        if not self.cuda:
            return hosts, None
        self.copy_stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self.copy_stream):
            dev = [h.to(self.device, non_blocking=True) for h in hosts]
            done = torch.cuda.Event()
            done.record(self.copy_stream)
        return dev, done

    def _install(self, g: int, tensors) -> None:
        s, e = self.groups[g]
        it = iter(tensors)
        compute = torch.cuda.current_stream(self.device) if self.cuda else None
        for l in range(s, e):
            for _, mod, attr, _ in self.layers[l]:
                t = next(it)
                if compute is not None:
                    t.record_stream(compute)  # allocated on the copy stream
                mod.__dict__[attr] = t

    def _release(self, g: int) -> None:
        s, e = self.groups[g]
        for l in range(s, e):
            for _, mod, attr, _ in self.layers[l]:
                mod.__dict__[attr] = None

    def forward(self, meta: ForwardMeta, kv: KVCache) -> torch.Tensor:
        """The model's forward with its layers streamed group by group."""
        model = self.model
        x = model.embed_tokens(meta)
        nxt = self._fetch(0)
        for g, (s, e) in enumerate(self.groups):
            tensors, done = nxt
            if g + 1 < len(self.groups):
                nxt = self._fetch(g + 1)  # copies while group g computes
            if done is not None:
                torch.cuda.current_stream(self.device).wait_event(done)
            self._install(g, tensors)
            x = model.run_layers(x, meta, kv, s, e)
            self._release(g)
        return model.finish(x, meta)

    def state_dict(self) -> dict[str, torch.Tensor]:
        """The resident tensors' and the host layers' state, by name."""
        out = dict(self.model.state_dict())
        for entries in self.layers:
            out.update((name, h) for name, _, _, h in entries)
        return out

    def load_state_dict(self, state: dict[str, torch.Tensor]) -> None:
        """Copy ``state`` (every name of ``state_dict``) in place."""
        state = dict(state)
        for entries in self.layers:
            for name, _, _, h in entries:
                h.copy_(state.pop(name))
        self.model.load_state_dict(state)
