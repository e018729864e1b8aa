"""Per-request custom logit processors.

Counterpart of ``scratchpad_tpu/sampling/custom_logit_processor.py`` with a
torch contract. A processor is a callable ``fn(logits, params) -> logits``:

- ``logits`` is f32 ``[B, V]`` on the logits' device: a copy of the whole
  padded batch's logits. Rows that did not ask for this processor are
  blended back afterwards by a row mask from the sampler's own tensor, so
  the callable may transform every row, in place or not.
- ``params`` is a dict of f32 ``[B]`` tensors on the same device, one entry
  for each key that any of the processor's requests names in its
  ``custom_params`` (scalar values only; 0 on the rows that lack the key).

The sampler applies the processors first, before ``logit_bias``, the
penalties and a grammar's mask (``sampling/sampler.py::sample``). A batch
with a processor never runs as a pipelined decode window: the runner's
``_packed_supported`` and the scheduler's ``_pipeline_ok`` keep it on the
window path that fetches each window before the next.

Over HTTP a processor travels as base64(zlib(pickle(obj))), the JAX
package's scheme. Unpickling runs arbitrary code by design, so the server
decodes a payload only behind ``--enable-custom-logit-processor`` and
answers 400 without it. Equal payloads decode to one object (an LRU cache
of 64 payloads), so the requests that send one share one processor.
"""

from __future__ import annotations

import base64
import functools
import pickle
import zlib

import torch

_NEG = -1e30


class CustomLogitProcessor:
    """Subclass and implement ``__call__(logits, params)`` with torch ops."""

    def __call__(self, logits: torch.Tensor, params: dict) -> torch.Tensor:  # pragma: no cover
        raise NotImplementedError

    def to_str(self) -> str:
        return base64.b64encode(zlib.compress(pickle.dumps(self))).decode()

    @classmethod
    def from_str(cls, s: str) -> "CustomLogitProcessor":
        # cached by payload: the requests that send one payload share one
        # object, and so one processor group of a batch
        return _from_str_cached(s)


@functools.lru_cache(maxsize=64)
def _from_str_cached(s: str):
    return pickle.loads(zlib.decompress(base64.b64decode(s)))


class BannedTokensProcessor(CustomLogitProcessor):
    """Built in: bans a fixed list of token ids (``params`` unused). An id
    outside ``[0, V)`` bans nothing."""

    def __init__(self, token_ids):
        self.token_ids = tuple(int(t) for t in token_ids)

    def __call__(self, logits: torch.Tensor, params: dict) -> torch.Tensor:
        V = logits.shape[-1]
        ids = [t for t in self.token_ids if 0 <= t < V]
        if not ids:
            return logits
        return logits.index_fill(-1, torch.tensor(ids, device=logits.device), _NEG)

    # distinct id lists are distinct processors; equal ones are one group
    # of a batch, whether they came over HTTP or through the engine API
    def __hash__(self):
        return hash((type(self).__name__, self.token_ids))

    def __eq__(self, other):
        return type(other) is type(self) and other.token_ids == self.token_ids
