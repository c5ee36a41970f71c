"""Thin generation wrapper over the LLM provider.

Role parity with `src/rag/generator.py` (:50-170): system+user → provider
chat; errors surfaced in-band (never raised) so the pipeline's degradation
ladder can act on them.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Sequence

from ..providers.base import BaseLLMProvider


@dataclasses.dataclass
class GeneratedResponse:
    text: str
    model: str
    generation_time: float
    error: str | None = None

    @property
    def ok(self) -> bool:
        return self.error is None and bool(self.text.strip())


class Generator:
    def __init__(self, llm: BaseLLMProvider, temperature: float = 0.1,
                 max_tokens: int | None = None):
        self.llm = llm
        self.temperature = temperature
        self.max_tokens = max_tokens

    def generate(self, system_prompt: str, user_prompt: str,
                 temperature: float | None = None) -> GeneratedResponse:
        t0 = time.time()
        resp = self.llm.chat(
            [
                {"role": "system", "content": system_prompt},
                {"role": "user", "content": user_prompt},
            ],
            temperature=self.temperature if temperature is None
            else temperature,
            max_tokens=self.max_tokens,
        )
        return GeneratedResponse(
            text=resp.text,
            model=resp.model or self.llm.model_name,
            generation_time=time.time() - t0,
            error=(resp.error or ("réponse vide du modèle"
                                  if not resp.text.strip() else None)),
        )

    def stream(self, system_prompt: str, user_prompt: str,
               temperature: float | None = None,
               history: Sequence[dict] | None = None):
        """Yield text deltas for the same chat turn `generate` runs.
        Provider errors raise out of the iterator — the pipeline's
        streaming path catches them and degrades in-band (the streamed
        prefix plus an error-marked GeneratedResponse)."""
        messages = [{"role": "system", "content": system_prompt}]
        for turn in history or []:
            messages.append({
                "role": turn.get("role", "user"),
                "content": turn.get("content", ""),
            })
        messages.append({"role": "user", "content": user_prompt})
        yield from self.llm.chat_stream(
            messages,
            temperature=self.temperature if temperature is None
            else temperature,
            max_tokens=self.max_tokens,
        )

    def generate_streamed(self, system_prompt: str, user_prompt: str,
                          temperature: float | None = None,
                          on_delta=None,
                          history: Sequence[dict] | None = None
                          ) -> GeneratedResponse:
        """`generate` with a delta callback: `on_delta(text_delta)` fires
        as the provider streams. Provider errors degrade in-band exactly
        like `generate` (the partial streamed text is kept)."""
        t0 = time.time()
        pieces: list[str] = []
        err = None
        try:
            for delta in self.stream(system_prompt, user_prompt,
                                     temperature, history=history):
                pieces.append(delta)
                if on_delta is not None:
                    on_delta(delta)
        except Exception as e:  # noqa: BLE001 — in-band, never raised
            err = f"{type(e).__name__}: {e}"
        text = "".join(pieces)
        return GeneratedResponse(
            text=text,
            model=getattr(self.llm, "model_name", ""),
            generation_time=time.time() - t0,
            error=err or ("réponse vide du modèle"
                          if not text.strip() else None),
        )

    def generate_with_history(
        self,
        system_prompt: str,
        user_prompt: str,
        history: Sequence[dict] | None = None,
        temperature: float | None = None,
    ) -> GeneratedResponse:
        t0 = time.time()
        messages = [{"role": "system", "content": system_prompt}]
        for turn in history or []:
            messages.append({
                "role": turn.get("role", "user"),
                "content": turn.get("content", ""),
            })
        messages.append({"role": "user", "content": user_prompt})
        resp = self.llm.chat(
            messages,
            temperature=self.temperature if temperature is None
            else temperature,
            max_tokens=self.max_tokens,
        )
        return GeneratedResponse(
            text=resp.text,
            model=resp.model or self.llm.model_name,
            generation_time=time.time() - t0,
            error=(resp.error or ("réponse vide du modèle"
                                  if not resp.text.strip() else None)),
        )
