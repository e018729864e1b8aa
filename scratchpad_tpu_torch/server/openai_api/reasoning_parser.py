"""Reasoning-content extraction (<think> blocks).

A copy of ``scratchpad_tpu/server/openai_api/reasoning_parser.py`` for the PyTorch port
(standard library only; it imports nothing of the JAX package).

Analogue of the reference reasoning parser
(reference: scratchpad/server/openai_api/reasoning_parser.py): splits
DeepSeek-R1/Qwen-style <think>...</think> spans into `reasoning_content`,
leaving the visible answer in `content`. Handles the common case where the
model omits the opening tag but emits `</think>`.
"""

from __future__ import annotations

import re
from typing import Optional


_TAGGED = re.compile(r"<think>(.*?)</think>", re.DOTALL)


def split_reasoning(text: str) -> tuple[Optional[str], str]:
    """Returns (reasoning_content or None, visible_content)."""
    spans = _TAGGED.findall(text)
    if spans:
        visible = _TAGGED.sub("", text).strip()
        return "\n".join(s.strip() for s in spans), visible
    # R1 style: reasoning first, closing tag only
    if "</think>" in text:
        reasoning, _, visible = text.partition("</think>")
        return reasoning.strip(), visible.strip()
    return None, text


_OPEN = "<think>"
_CLOSE = "</think>"


def _partial_suffix(s: str, tag: str) -> int:
    """Length of the longest PROPER prefix of `tag` that `s` ends with —
    text that must be held back because the next chunk may complete it."""
    for k in range(min(len(s), len(tag) - 1), 0, -1):
        if s.endswith(tag[:k]):
            return k
    return 0


class StreamingReasoningParser:
    """Incremental `<think>` separation for SSE streaming.

    Analogue of the reference's streaming mode
    (reference: scratchpad/server/openai_api/reasoning_parser.py:47-118
    `parse_streaming_increment`): each fed text delta is split into a
    (reasoning_delta, content_delta) pair as tags arrive, holding back any
    trailing text that could be the start of a tag split across chunks.

    ``force_reasoning`` starts the stream inside a think block (DeepSeek-R1
    templates open the tag in the prompt, so the model emits reasoning
    first and only the closing tag). A redundant leading ``<think>`` in
    that mode is swallowed. ``stream_reasoning=False`` accumulates the
    reasoning span and emits it whole in the chunk where the block closes.
    """

    def __init__(self, force_reasoning: bool = False,
                 stream_reasoning: bool = True):
        self.in_reasoning = force_reasoning
        self.stream_reasoning = stream_reasoning
        self.buf = ""
        self._held: list[str] = []  # reasoning held when not streaming it
        self._at_start = True
        self._force = force_reasoning

    def feed(self, delta: str) -> tuple[Optional[str], str]:
        """Returns (reasoning_delta or None, content_delta)."""
        self.buf += delta
        reasoning: list[str] = []
        content: list[str] = []
        while self.buf:
            if self._at_start and self._force:
                # swallow a redundant opening tag at position 0
                if self.buf.startswith(_OPEN):
                    self.buf = self.buf[len(_OPEN):]
                    self._at_start = False
                    continue
                if len(self.buf) < len(_OPEN) and _OPEN.startswith(self.buf):
                    break  # could still become the opening tag
                self._at_start = False
                continue
            self._at_start = False
            tag = _CLOSE if self.in_reasoning else _OPEN
            i = self.buf.find(tag)
            if i >= 0:
                span, self.buf = self.buf[:i], self.buf[i + len(tag):]
                if self.in_reasoning:
                    if self.stream_reasoning:
                        reasoning.append(span)
                    else:
                        self._held.append(span)
                        reasoning.append("".join(self._held))
                        self._held = []
                else:
                    content.append(span)
                self.in_reasoning = not self.in_reasoning
                continue
            hold = _partial_suffix(self.buf, tag)
            emit, self.buf = self.buf[: len(self.buf) - hold], (
                self.buf[len(self.buf) - hold:]
            )
            if emit:
                if self.in_reasoning:
                    (reasoning if self.stream_reasoning
                     else self._held).append(emit)
                else:
                    content.append(emit)
            break
        r = "".join(reasoning)
        return (r if r else None), "".join(content)

    def finish(self) -> tuple[Optional[str], str]:
        """Flush held-back text (unterminated tag prefixes / unclosed
        reasoning) in the current mode."""
        tail, self.buf = self.buf, ""
        if self.in_reasoning:
            self._held.append(tail)
            r = "".join(self._held)
            self._held = []
            return (r if r else None), ""
        return None, tail
