"""LLM provider factory: local / hybrid / hosted / fake modes.

Port of `rag_dpo_tpu/providers/factory.py`. `HostedAPIProvider` and
`create_llm` are the JAX package's, line for line
(`tests/test_torch_bootstrap.py` holds them to it): `local` is the
Ollama-protocol endpoint (`HTTPLLMProvider`), `hosted` an OpenAI-style
chat-completions API, `hybrid` the hosted API when it has a key, else the
local endpoint when it answers, else the fake; `fake` the deterministic
test provider. Mode `tpu`, the in-process decoder, waits for the
decoder's port (ROADMAP item 7b): `create_tpu_llm` raises.
"""

from __future__ import annotations

import json
import os
import time
import urllib.request

from .base import BaseLLMProvider, LLMResponse
from .fake import FakeLLMProvider
from .http_llm import HTTPLLMProvider


class HostedAPIProvider(BaseLLMProvider):
    """OpenAI-compatible chat-completions client (Mistral-API class:
    EU-hosted, key-authenticated). stdlib-only."""

    def __init__(self, base_url: str = "https://api.mistral.ai/v1",
                 api_key: str | None = None,
                 model: str = "mistral-small-latest",
                 timeout: float = 120.0):
        self.base_url = base_url.rstrip("/")
        self.api_key = api_key or os.environ.get("RAGDPO_API_KEY", "")
        self.model_name = model
        self.timeout = timeout

    def chat(self, messages, temperature=0.0, max_tokens=None):
        t0 = time.time()
        payload = {
            "model": self.model_name,
            "messages": list(messages),
            "temperature": temperature,
        }
        if max_tokens:
            payload["max_tokens"] = max_tokens
        req = urllib.request.Request(
            self.base_url + "/chat/completions",
            data=json.dumps(payload).encode(),
            headers={
                "Content-Type": "application/json",
                "Authorization": f"Bearer {self.api_key}",
            },
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                out = json.loads(r.read())
            text = out["choices"][0]["message"]["content"]
            return LLMResponse(text, self.model_name, time.time() - t0)
        except Exception as e:
            return LLMResponse("", self.model_name, time.time() - t0,
                               error=str(e))

    def generate(self, prompt, system=None, temperature=0.0,
                 json_mode=False, max_tokens=None):
        messages = []
        if system:
            messages.append({"role": "system", "content": system})
        messages.append({"role": "user", "content": prompt})
        return self.chat(messages, temperature=temperature,
                         max_tokens=max_tokens)

    def is_available(self) -> bool:
        return bool(self.api_key)


def create_tpu_llm(**kwargs) -> BaseLLMProvider:
    """The in-process decoder as the provider: not ported yet."""
    raise NotImplementedError(
        "LLM mode 'tpu' (the in-process decoder) is not ported yet "
        "(ROADMAP, port queue item 7b: the decoder); use mode 'local', "
        "'hosted', 'hybrid' or 'fake', or inject an llm")


def create_llm(mode: str = "local", *, base_url: str | None = None,
               model: str | None = None,
               api_key: str | None = None,
               **tpu_kwargs) -> BaseLLMProvider:
    """mode: local | hybrid | hosted | tpu | fake (env RAGDPO_LLM_MODE)."""
    mode = mode or os.environ.get("RAGDPO_LLM_MODE", "local")
    if mode == "fake":
        return FakeLLMProvider()
    if mode == "tpu":
        return create_tpu_llm(model=model, **tpu_kwargs)
    local = HTTPLLMProvider(
        base_url=base_url or os.environ.get("RAGDPO_LLM_BASE_URL",
                                            "http://localhost:11434"),
        model=model or os.environ.get("RAGDPO_LLM_MODEL",
                                      "mistral-nemo:12b"),
    )
    if mode == "local":
        return local
    hosted = HostedAPIProvider(api_key=api_key)
    if mode == "hosted":
        return hosted
    if mode == "hybrid":
        if hosted.is_available():
            return hosted
        if local.is_available():
            return local
        return FakeLLMProvider()
    raise ValueError(f"unknown llm mode: {mode}")
