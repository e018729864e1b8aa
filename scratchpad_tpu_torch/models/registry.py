"""Model registry mapping HF architecture names to implementations.

Counterpart of ``scratchpad_tpu/models/registry.py``. The port has the Llama
family (Mistral included: Llama's architecture and weight names with a
uniform sliding window), Qwen2, Qwen3, Phi-3 and Apertus on the Llama
decoder, Gemma 2 and Gemma 3 (text), the MoE decoders Mixtral,
Qwen3-MoE, GPT-OSS and Llama-4 (text), DeepSeek-V2 and V3 (multi-head
latent attention), and the vision models LLaVA (CLIP on Llama), Qwen2-VL
and Gemma 3 multimodal (SigLIP); the rest of the JAX package's model zoo
(Mllama, whose cross-attention is the next slice) is still to be ported.
"""

from __future__ import annotations


def get_model_class(architecture: str):
    from scratchpad_tpu_torch.models.apertus import ApertusForCausalLM
    from scratchpad_tpu_torch.models.deepseek import DeepseekV2ForCausalLM, DeepseekV3ForCausalLM
    from scratchpad_tpu_torch.models.gemma import (
        Gemma2ForCausalLM,
        Gemma3ForCausalLM,
        Gemma3ForConditionalGeneration,
    )
    from scratchpad_tpu_torch.models.gpt_oss import GptOssForCausalLM
    from scratchpad_tpu_torch.models.llama import LlamaForCausalLM
    from scratchpad_tpu_torch.models.llama4 import Llama4ForCausalLM
    from scratchpad_tpu_torch.models.llava import LlavaForConditionalGeneration
    from scratchpad_tpu_torch.models.mixtral import MixtralForCausalLM, Qwen3MoeForCausalLM
    from scratchpad_tpu_torch.models.qwen import (
        Phi3ForCausalLM,
        Qwen2ForCausalLM,
        Qwen3ForCausalLM,
    )
    from scratchpad_tpu_torch.models.qwen2_vl import Qwen2VLForConditionalGeneration

    registry = {
        "LlamaForCausalLM": LlamaForCausalLM,
        "MistralForCausalLM": LlamaForCausalLM,
        "Qwen2ForCausalLM": Qwen2ForCausalLM,
        "Qwen3ForCausalLM": Qwen3ForCausalLM,
        "Phi3ForCausalLM": Phi3ForCausalLM,
        "Gemma2ForCausalLM": Gemma2ForCausalLM,
        "Gemma3ForCausalLM": Gemma3ForCausalLM,
        "MixtralForCausalLM": MixtralForCausalLM,
        "Qwen3MoeForCausalLM": Qwen3MoeForCausalLM,
        "GptOssForCausalLM": GptOssForCausalLM,
        "Llama4ForCausalLM": Llama4ForCausalLM,
        "Llama4TextModel": Llama4ForCausalLM,
        "ApertusForCausalLM": ApertusForCausalLM,
        "DeepseekV2ForCausalLM": DeepseekV2ForCausalLM,
        "DeepseekV3ForCausalLM": DeepseekV3ForCausalLM,
        "LlavaForConditionalGeneration": LlavaForConditionalGeneration,
        "Qwen2VLForConditionalGeneration": Qwen2VLForConditionalGeneration,
        "Gemma3ForConditionalGeneration": Gemma3ForConditionalGeneration,
    }
    if architecture == "MllamaForConditionalGeneration":
        raise NotImplementedError(
            "architecture 'MllamaForConditionalGeneration' is not ported yet: its "
            "cross-attention layers (cross_slots, cross_states in core/) are the next slice "
            "(ROADMAP Queue 1)"
        )
    if architecture not in registry:
        raise NotImplementedError(
            f"architecture {architecture!r} is not ported yet; have {sorted(registry)}"
        )
    return registry[architecture]
