"""Named chat conversation templates.

A copy of ``scratchpad_tpu/server/openai_api/conversation.py`` for the PyTorch port
(standard library only; it imports nothing of the JAX package).

Re-creation of the reference's conversation registry
(reference: scratchpad/server/openai_api/conversation.py — SeparatorStyle
renderers + register_conv_template entries: llama-2, chatml, chatml-llava,
vicuna_v1.1, llava_llama_3, internlm2-chat, llama_3_vision, qwen2-vl,
gemma-it): when a tokenizer ships no chat_template, a named template (or one
inferred from the model name) renders the message list. This registry also
covers the model families this engine serves beyond the reference zoo
(phi-3, deepseek, gpt-oss harmony, zephyr, llama-4).

Renderers take the OpenAI ``messages`` list (dicts with role/content; image
parts are already flattened to the ``mm_image_token`` placeholder by the
server) and return the prompt string ending with the assistant header.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional


@dataclasses.dataclass
class Conversation:
    name: str
    render: Callable[[list[dict]], str]
    stop: list[str] = dataclasses.field(default_factory=list)
    # image placeholder this template's model family expects; the server
    # substitutes its mm_image_token when building multimodal prompts
    image_token: Optional[str] = None


def _sys_of(messages: list[dict]) -> tuple[str, list[dict]]:
    """Split out a leading system message (most templates fold it into the
    first user turn or a dedicated header)."""
    if messages and messages[0]["role"] == "system":
        return messages[0].get("content") or "", messages[1:]
    return "", messages


def _llama3(messages: list[dict]) -> str:
    out = ["<|begin_of_text|>"]
    for m in messages:
        out.append(
            f"<|start_header_id|>{m['role']}<|end_header_id|>\n\n"
            f"{m.get('content') or ''}<|eot_id|>"
        )
    out.append("<|start_header_id|>assistant<|end_header_id|>\n\n")
    return "".join(out)


def _llama2(messages: list[dict]) -> str:
    sys_txt, messages = _sys_of(messages)
    out = []
    pending = f"<<SYS>>\n{sys_txt}\n<</SYS>>\n\n" if sys_txt else ""
    for m in messages:
        if m["role"] == "user":
            out.append(f"<s>[INST] {pending}{m.get('content') or ''} [/INST]")
            pending = ""
        elif m["role"] == "assistant":
            out.append(f" {m.get('content') or ''} </s>")
    return "".join(out)


def _chatml(messages: list[dict]) -> str:  # qwen & friends
    out = []
    for m in messages:
        out.append(f"<|im_start|>{m['role']}\n{m.get('content') or ''}<|im_end|>\n")
    out.append("<|im_start|>assistant\n")
    return "".join(out)


def _gemma(messages: list[dict]) -> str:
    out = ["<bos>"]
    sys_txt, messages = _sys_of(messages)
    first_user = True
    for m in messages:
        role = "model" if m["role"] == "assistant" else "user"
        content = m.get("content") or ""
        if role == "user" and first_user and sys_txt:
            content = f"{sys_txt}\n\n{content}"
            first_user = False
        out.append(f"<start_of_turn>{role}\n{content}<end_of_turn>\n")
    out.append("<start_of_turn>model\n")
    return "".join(out)


def _mistral(messages: list[dict]) -> str:
    out = ["<s>"]
    sys_txt = ""
    for m in messages:
        if m["role"] == "system":
            sys_txt = m.get("content") or ""
        elif m["role"] == "user":
            content = m.get("content") or ""
            if sys_txt:
                content = f"{sys_txt}\n\n{content}"
                sys_txt = ""
            out.append(f"[INST] {content} [/INST]")
        elif m["role"] == "assistant":
            out.append(f"{m.get('content') or ''}</s>")
    return "".join(out)


def _vicuna(messages: list[dict]) -> str:
    sys_txt, messages = _sys_of(messages)
    if not sys_txt:
        sys_txt = (
            "A chat between a curious user and an artificial intelligence "
            "assistant. The assistant gives helpful, detailed, and polite "
            "answers to the user's questions."
        )
    out = [sys_txt, " "]
    for m in messages:
        role = "USER" if m["role"] == "user" else "ASSISTANT"
        if role == "USER":
            out.append(f"USER: {m.get('content') or ''} ")
        else:
            out.append(f"ASSISTANT: {m.get('content') or ''}</s>")
    out.append("ASSISTANT:")
    return "".join(out)


def _phi3(messages: list[dict]) -> str:
    out = []
    for m in messages:
        out.append(f"<|{m['role']}|>\n{m.get('content') or ''}<|end|>\n")
    out.append("<|assistant|>\n")
    return "".join(out)


def _deepseek(messages: list[dict]) -> str:
    sys_txt, messages = _sys_of(messages)
    out = [f"<|begin_of_sentence|>{sys_txt}" if sys_txt else "<|begin_of_sentence|>"]
    for m in messages:
        if m["role"] == "user":
            out.append(f"<|User|>{m.get('content') or ''}")
        elif m["role"] == "assistant":
            out.append(f"<|Assistant|>{m.get('content') or ''}<|end_of_sentence|>")
    out.append("<|Assistant|>")
    return "".join(out)


def _internlm2(messages: list[dict]) -> str:
    # chatml dialect with its own special tokens
    out = []
    for m in messages:
        out.append(f"<|im_start|>{m['role']}\n{m.get('content') or ''}<|im_end|>\n")
    out.append("<|im_start|>assistant\n")
    return "".join(out)


def _zephyr(messages: list[dict]) -> str:
    out = []
    for m in messages:
        out.append(f"<|{m['role']}|>\n{m.get('content') or ''}</s>\n")
    out.append("<|assistant|>\n")
    return "".join(out)


def _harmony(messages: list[dict]) -> str:
    """GPT-OSS harmony-style rendering (simplified: final channel only)."""
    out = []
    for m in messages:
        role = m["role"]
        content = m.get("content") or ""
        if role == "assistant":
            out.append(
                f"<|start|>assistant<|channel|>final<|message|>{content}<|end|>"
            )
        else:
            out.append(f"<|start|>{role}<|message|>{content}<|end|>")
    out.append("<|start|>assistant")
    return "".join(out)


def _plain(messages: list[dict]) -> str:
    parts = [f"<|{m['role']}|>\n{m.get('content') or ''}" for m in messages]
    parts.append("<|assistant|>\n")
    return "\n".join(parts)


def _conv(name, fn, stop, image_token=None):
    return Conversation(name, fn, stop=stop, image_token=image_token)


TEMPLATES: dict[str, Conversation] = {
    # reference-registered names (conversation.py:463-568)
    "llama-2": _conv("llama-2", _llama2, ["</s>"]),
    "chatml": _conv("chatml", _chatml, ["<|im_end|>"]),
    "chatml-llava": _conv(
        "chatml-llava", _chatml, ["<|im_end|>"], image_token="<image>"
    ),
    "vicuna_v1.1": _conv("vicuna_v1.1", _vicuna, ["</s>"], image_token="<image>"),
    "llava_llama_3": _conv(
        "llava_llama_3", _llama3, ["<|eot_id|>"], image_token="<image>"
    ),
    "internlm2-chat": _conv("internlm2-chat", _internlm2, ["<|im_end|>"]),
    "llama_3_vision": _conv(
        "llama_3_vision", _llama3, ["<|eot_id|>"], image_token="<|image|>"
    ),
    "qwen2-vl": _conv(
        "qwen2-vl", _chatml, ["<|im_end|>"], image_token="<|image_pad|>"
    ),
    "gemma-it": _conv(
        "gemma-it", _gemma, ["<end_of_turn>"], image_token="<start_of_image>"
    ),
    # engine families beyond the reference registry
    "llama-3": _conv("llama-3", _llama3, ["<|eot_id|>"]),
    "qwen": _conv("qwen", _chatml, ["<|im_end|>"]),
    "gemma": _conv("gemma", _gemma, ["<end_of_turn>"]),
    "mistral": _conv("mistral", _mistral, ["</s>"]),
    "phi-3": _conv("phi-3", _phi3, ["<|end|>"]),
    "deepseek": _conv("deepseek", _deepseek, ["<|end_of_sentence|>"]),
    "zephyr": _conv("zephyr", _zephyr, ["</s>"]),
    "gpt-oss": _conv("gpt-oss", _harmony, ["<|end|>", "<|return|>"]),
    "plain": _conv("plain", _plain, []),
}

# model-name substring -> template, first match wins (normalised: lowercase,
# separators stripped)
_INFER_ORDER = (
    ("llava", "chatml-llava"),
    ("mllama", "llama_3_vision"),
    ("qwen2vl", "qwen2-vl"),
    ("llama2", "llama-2"),
    ("llama", "llama-3"),
    ("qwen", "qwen"),
    ("gemma", "gemma"),
    ("mixtral", "mistral"),
    ("mistral", "mistral"),
    ("phi3", "phi-3"),
    ("phi", "phi-3"),
    ("deepseek", "deepseek"),
    ("internlm", "internlm2-chat"),
    ("vicuna", "vicuna_v1.1"),
    ("zephyr", "zephyr"),
    ("gptoss", "gpt-oss"),
    ("tinyllama", "zephyr"),
)


def get_template(
    name: Optional[str] = None, model_name: Optional[str] = None
) -> Conversation:
    """Resolve by explicit name, else infer from the model name."""
    if name:
        return TEMPLATES[name]
    m = (model_name or "").lower().replace("-", "").replace("_", "")
    if "llama" in m and "vision" in m:
        return TEMPLATES["llama_3_vision"]
    for key, tmpl in _INFER_ORDER:
        if key in m:
            return TEMPLATES[tmpl]
    return TEMPLATES["plain"]
