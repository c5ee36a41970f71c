"""LLM provider abstraction.

Generation is not a TPU-retrieval workload: like the reference (OllamaProvider
HTTP client, `src/utils/llm_provider.py:34-241`), the generator LLM lives
behind a provider interface — any OpenAI/Ollama-style endpoint, or the
deterministic fake used by tests (the reference has no fake; SURVEY.md §4
calls this gap out explicitly).
"""

from __future__ import annotations

import abc
import dataclasses
import time
from typing import Any, Mapping, Sequence


@dataclasses.dataclass
class LLMResponse:
    text: str
    model: str = ""
    duration: float = 0.0
    error: str | None = None
    # per-token logprobs when the caller asked for them (providers
    # that support it): [{"id", "token", "logprob", "top_logprobs":
    # [{"id", "token", "logprob"}...]}, ...]; None otherwise
    logprobs: list | None = None
    # structural error class so HTTP layers never classify by
    # substring-matching error text (advisor r3): "input" = caller/
    # capability error (maps to 400), None/anything else = server-side
    # failure (maps to 502)
    error_kind: str | None = None

    @property
    def ok(self) -> bool:
        return self.error is None


def background_priority_kwargs(llm, level: int = 1) -> dict:
    """Generate-kwargs marking a call as background-class on providers
    with a priority-aware scheduler (the TPU continuous slot pool); {}
    elsewhere, so HTTP/fake provider signatures stay untouched. Batch
    pipelines (tagging, summaries) pass these so that, when they share
    a serving process, interactive chat traffic outranks them."""
    return {"priority": int(level)} if hasattr(llm, "priority") else {}


class BaseLLMProvider(abc.ABC):
    model_name: str = "unknown"

    @abc.abstractmethod
    def generate(
        self,
        prompt: str,
        system: str | None = None,
        temperature: float = 0.0,
        json_mode: bool = False,
        max_tokens: int | None = None,
    ) -> LLMResponse: ...

    def chat(
        self,
        messages: Sequence[Mapping[str, str]],
        temperature: float = 0.0,
        max_tokens: int | None = None,
        **gen_kwargs,
    ) -> LLMResponse:
        """Default chat = flatten messages into a generate call.
        Extra `gen_kwargs` (penalties, priority, timeout_s...) forward
        to `generate` for providers that accept them."""
        system = None
        parts = []
        for m in messages:
            if m["role"] == "system":
                system = m["content"]
            else:
                parts.append(f"{m['role']}: {m['content']}")
        if max_tokens is not None:
            gen_kwargs["max_tokens"] = max_tokens
        return self.generate("\n\n".join(parts), system=system,
                             temperature=temperature, **gen_kwargs)

    def chat_stream(
        self,
        messages: Sequence[Mapping[str, str]],
        temperature: float = 0.0,
        max_tokens: int | None = None,
        **gen_kwargs,
    ):
        """Yield text deltas for a chat turn. Providers with a native
        token stream override this (TPULLMProvider wires the decoder's
        chunked decode; an Ollama-style HTTP backend would forward its
        SSE deltas). The default falls back to ONE delta carrying the
        complete `chat()` answer, so every provider is streamable.
        Extra `gen_kwargs` forward through `chat()` to `generate()`.
        Errors raise (callers convert to in-band per the degradation
        ladder)."""
        resp = self.chat(messages, temperature=temperature,
                         max_tokens=max_tokens, **gen_kwargs)
        if resp.error:
            raise RuntimeError(resp.error)
        if resp.text:
            yield resp.text

    def generate_with_image(
        self, prompt: str, image_bytes: bytes, temperature: float = 0.0
    ) -> LLMResponse:
        return LLMResponse(text="", error="vision not supported",
                           error_kind="input")

    def is_available(self) -> bool:
        return True


class timed_call:
    def __enter__(self):
        self.t0 = time.time()
        return self

    def __exit__(self, *a):
        self.duration = time.time() - self.t0
        return False
