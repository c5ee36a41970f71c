"""HTTP LLM provider for Ollama-compatible local endpoints.

Functional analog of the reference's `OllamaProvider`
(`src/utils/llm_provider.py:34-241`): /api/generate and /api/chat with
num_ctx, optional JSON formatting, vision via base64 images. Implemented on
stdlib urllib (no extra deps); errors are returned in-band so callers can
degrade gracefully (same degradation-ladder philosophy as SURVEY.md §5).
"""

from __future__ import annotations

import base64
import json
import time
import urllib.error
import urllib.request
from typing import Mapping, Sequence

from .base import BaseLLMProvider, LLMResponse


class HTTPLLMProvider(BaseLLMProvider):
    def __init__(
        self,
        base_url: str = "http://localhost:11434",
        model: str = "mistral-nemo:12b",
        num_ctx: int = 16384,
        timeout: float = 180.0,
    ):
        self.base_url = base_url.rstrip("/")
        self.model_name = model
        self.num_ctx = num_ctx
        self.timeout = timeout

    def _post(self, path: str, payload: dict) -> dict:
        req = urllib.request.Request(
            self.base_url + path,
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            return json.loads(resp.read())

    def generate(self, prompt, system=None, temperature=0.0,
                 json_mode=False, max_tokens=None) -> LLMResponse:
        t0 = time.time()
        payload = {
            "model": self.model_name,
            "prompt": prompt,
            "stream": False,
            "options": {"temperature": temperature, "num_ctx": self.num_ctx},
        }
        if system:
            payload["system"] = system
        if json_mode:
            payload["format"] = "json"
        if max_tokens:
            payload["options"]["num_predict"] = max_tokens
        try:
            out = self._post("/api/generate", payload)
            return LLMResponse(out.get("response", ""), self.model_name,
                               time.time() - t0)
        except Exception as e:  # connection refused, timeout, bad JSON …
            return LLMResponse("", self.model_name, time.time() - t0,
                               error=str(e))

    def chat(self, messages: Sequence[Mapping[str, str]],
             temperature: float = 0.0, max_tokens=None) -> LLMResponse:
        t0 = time.time()
        payload = {
            "model": self.model_name,
            "messages": list(messages),
            "stream": False,
            "options": {"temperature": temperature, "num_ctx": self.num_ctx},
        }
        if max_tokens:
            payload["options"]["num_predict"] = max_tokens
        try:
            out = self._post("/api/chat", payload)
            return LLMResponse(
                out.get("message", {}).get("content", ""),
                self.model_name, time.time() - t0,
            )
        except Exception as e:
            return LLMResponse("", self.model_name, time.time() - t0,
                               error=str(e))

    def chat_stream(self, messages: Sequence[Mapping[str, str]],
                    temperature: float = 0.0, max_tokens=None):
        """True token streaming from the Ollama endpoint: /api/chat with
        "stream": true emits one JSON object per line; each carries a
        message.content delta. The reference's backend supports exactly
        this but its app never used it (`src/utils/llm_provider.py:150`
        hardcodes stream=False); here it feeds the end-to-end streaming
        /query path. Errors raise (pipeline converts to in-band)."""
        payload = {
            "model": self.model_name,
            "messages": list(messages),
            "stream": True,
            "options": {"temperature": temperature,
                        "num_ctx": self.num_ctx},
        }
        if max_tokens:
            payload["options"]["num_predict"] = max_tokens
        req = urllib.request.Request(
            self.base_url + "/api/chat",
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            for line in resp:
                line = line.strip()
                if not line:
                    continue
                obj = json.loads(line)
                if obj.get("error"):
                    raise RuntimeError(str(obj["error"]))
                delta = obj.get("message", {}).get("content", "")
                if delta:
                    yield delta
                if obj.get("done"):
                    break

    def generate_with_image(self, prompt, image_bytes, temperature=0.0):
        t0 = time.time()
        payload = {
            "model": self.model_name,
            "prompt": prompt,
            "stream": False,
            "images": [base64.b64encode(image_bytes).decode()],
            "options": {"temperature": temperature},
        }
        try:
            out = self._post("/api/generate", payload)
            return LLMResponse(out.get("response", ""), self.model_name,
                               time.time() - t0)
        except Exception as e:
            return LLMResponse("", self.model_name, time.time() - t0,
                               error=str(e))

    def is_available(self) -> bool:
        try:
            req = urllib.request.Request(self.base_url + "/api/tags")
            with urllib.request.urlopen(req, timeout=3.0):
                return True
        except Exception:
            return False
