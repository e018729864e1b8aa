"""Model registry mapping HF architecture names to implementations.

Counterpart of ``scratchpad_tpu/models/registry.py``. The port has the Llama
family only, Mistral included (Llama's architecture and weight names with a
uniform sliding window); the rest of the JAX package's model zoo is still to
be ported.
"""

from __future__ import annotations


def get_model_class(architecture: str):
    from scratchpad_tpu_torch.models.llama import LlamaForCausalLM

    registry = {"LlamaForCausalLM": LlamaForCausalLM, "MistralForCausalLM": LlamaForCausalLM}
    if architecture not in registry:
        raise NotImplementedError(
            f"architecture {architecture!r} is not ported yet; have {sorted(registry)}"
        )
    return registry[architecture]
