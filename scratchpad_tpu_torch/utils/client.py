"""Clients of a served OpenAI-compatible endpoint, on ``urllib``.

Counterpart of ``scratchpad_tpu/utils/client.py`` (``requests``): a chat
wrapper with usage and cost accounting (``LLM``) and an embedding client
(``LLMEncoder``), against this port's server or any OpenAI-compatible host.
"""

from __future__ import annotations

import json
import os
import time
import urllib.request
from typing import List, Optional

import numpy as np


def post_json(url: str, body: dict, headers: Optional[dict] = None, timeout: float = 120) -> dict:
    """POST ``body`` as JSON; the JSON answer. A status >= 400 raises
    ``urllib.error.HTTPError``."""
    req = urllib.request.Request(
        url,
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})},
    )
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def _retry(fn, attempts: int = 3, wait_s: float = 2.0):
    last = None
    for _ in range(attempts):
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 - network retry wrapper
            last = e
            time.sleep(wait_s)
    raise last


def _endpoint(base_url: Optional[str], api_key: Optional[str], path: str):
    base_url = base_url or os.environ.get("RC_API_BASE")
    api_key = api_key or os.environ.get("RC_API_KEY", "none")
    if not base_url:
        raise ValueError("base_url not given and RC_API_BASE unset")
    return base_url.rstrip("/") + path, {"Authorization": f"Bearer {api_key}"}


class LLM:
    """Minimal chat-completions client with usage and cost accounting."""

    def __init__(
        self,
        model: str,
        base_url: Optional[str] = None,
        api_key: Optional[str] = None,
        system_prompt: Optional[str] = None,
        price_per_mtokens: Optional[float] = None,
    ):
        self.model = model
        self.base_url, self.headers = _endpoint(base_url, api_key, "/chat/completions")
        self.system_prompt = system_prompt or "You are a helpful assistant."
        self._prompt_tokens = 0
        self._completion_tokens = 0
        self.price_per_million_tokens = price_per_mtokens

    def set_system_prompt(self, system_prompt: str) -> None:
        self.system_prompt = system_prompt

    def set_pricing_per_mtokens(self, price: float) -> None:
        self.price_per_million_tokens = price

    def __call__(self, prompt: str, max_tokens: int = 10, temperature: float = 0.5) -> Optional[str]:
        body = {
            "model": self.model,
            "messages": [
                {"role": "system", "content": self.system_prompt},
                {"role": "user", "content": prompt},
            ],
            "max_tokens": max_tokens,
            "temperature": temperature,
        }
        result = _retry(lambda: post_json(self.base_url, body, self.headers))
        self._prompt_tokens += result["usage"]["prompt_tokens"]
        self._completion_tokens += result["usage"]["completion_tokens"]
        return result["choices"][0]["message"]["content"]

    @property
    def usage(self) -> dict:
        return {
            "total_tokens": self._prompt_tokens + self._completion_tokens,
            "prompt_tokens": self._prompt_tokens,
            "completion_tokens": self._completion_tokens,
            "cost": (
                self.price_per_million_tokens * self._completion_tokens / 1e6
                if self.price_per_million_tokens
                else None
            ),
        }


class LLMEncoder:
    """Embedding client over /v1/embeddings."""

    def __init__(self, model: str, base_url: Optional[str] = None, api_key: Optional[str] = None):
        self.model = model
        self.base_url, self.headers = _endpoint(base_url, api_key, "/embeddings")

    def __call__(self, docs: List[str]) -> np.ndarray:
        body = {"model": self.model, "input": docs, "encoding_format": "float"}
        data = _retry(lambda: post_json(self.base_url, body, self.headers))["data"]
        return np.array([d["embedding"] for d in data], np.float32)
