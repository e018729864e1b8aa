"""Incremental detokenization with surrogate-safe offsets.

In-process re-implementation of the reference DetokenizerManager's
surr/read-offset algorithm (reference: scratchpad/managers/detokenizer.py:33-205).
The reference runs this in a separate OS process fed over ZMQ; under a
single-controller JAX engine it is just a per-request incremental decode on
the host, overlapped with device steps by async dispatch.
"""

from __future__ import annotations

from scratchpad_tpu_torch.core.req import FinishReason, Req

_REPLACEMENT = "�"


class IncrementalDetokenizer:
    def __init__(self, tokenizer):
        self.tokenizer = tokenizer

    def step(self, req: Req) -> str:
        """Decode newly generated tokens; returns the new text chunk."""
        if self.tokenizer is None:
            return ""
        ids = req.output_ids
        sp = req.sampling_params
        kw = dict(
            skip_special_tokens=sp.skip_special_tokens,
            spaces_between_special_tokens=sp.spaces_between_special_tokens,
        )
        surr_text = self.tokenizer.decode(ids[req.surr_offset : req.read_offset], **kw)
        full_text = self.tokenizer.decode(ids[req.surr_offset :], **kw)
        if full_text.endswith(_REPLACEMENT) and not req.finished():
            # byte-level tail is mid-codepoint; hold until complete
            return ""
        new_text = full_text[len(surr_text) :]
        req.decoded_text += new_text
        req.surr_offset = req.read_offset
        req.read_offset = len(ids)
        return new_text

    def check_stop_strings(self, req: Req) -> bool:
        """Trim at the earliest stop string; returns True if req finishes
        (reference: detokenizer trims via Req stop_strs)."""
        stops = req.sampling_params.stop
        if not stops:
            return False
        text = req.decoded_text
        cut = -1
        for s in stops:
            pos = text.find(s)
            if pos >= 0 and (cut < 0 or pos < cut):
                cut = pos
        if cut >= 0:
            req.decoded_text = text[:cut]
            req.finished_reason = FinishReason.STOP_STR
            return True
        return False

    @staticmethod
    def stream_safe_len(req: Req) -> int:
        """Chars safe to stream now: hold back a possible stop-string prefix."""
        stops = req.sampling_params.stop
        if not stops or req.finished():
            return len(req.decoded_text)
        hold = max(len(s) for s in stops) - 1
        return max(len(req.decoded_text) - hold, req.stream_sent_len)
