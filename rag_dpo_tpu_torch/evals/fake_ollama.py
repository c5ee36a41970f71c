"""A loopback endpoint of the Ollama protocol that answers as the fake LLM.

    with FakeOllama() as ollama:
        stack = build_stack(load_config(env={"RAGDPO_LLM_BASE_URL":
                                             ollama.url}), ...)

serves the shipped default config's `llm.mode="local"` (the HTTP provider,
`providers.http_llm`) with nothing leaving the machine: a stdlib
`ThreadingHTTPServer` on 127.0.0.1, a free port, in a daemon thread. Each
`/api/generate` answers what `FakeLLMProvider().generate(prompt, system=,
temperature=, json_mode=, max_tokens=)` answers, each `/api/chat` what its
`chat(messages, ...)` answers, in one JSON object (a streaming client reads
it as its one delta and the done line); an answer with an error becomes an
HTTP 500, which the HTTP provider turns into an in-band error. `paths`
records the path of every request. The listen backlog takes a concurrent
serve's bursts: at the stdlib's 5, connections of concurrent agents were
refused, which the HTTP provider turns into in-band errors and the query
expander into fewer query variants.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..providers.fake import FakeLLMProvider


class _Server(ThreadingHTTPServer):
    daemon_threads = True
    request_queue_size = 1024


class FakeOllama:
    def __init__(self):
        self.llm = FakeLLMProvider()
        self.paths: list[str] = []
        self.url = ""
        self._server: _Server | None = None
        self._thread: threading.Thread | None = None

    def __enter__(self) -> "FakeOllama":
        self._server = _Server(("127.0.0.1", 0), self._handler())
        self.url = f"http://127.0.0.1:{self._server.server_address[1]}"
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        name="fake-ollama", daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._server.shutdown()
        self._server.server_close()
        self._thread.join()

    def _answer(self, path: str, payload: dict):
        """The fake's LLMResponse for one request, or None (404)."""
        options = payload.get("options", {})
        kwargs = dict(temperature=options.get("temperature", 0.0),
                      max_tokens=options.get("num_predict"))
        if path == "/api/generate":
            return self.llm.generate(
                payload.get("prompt", ""), system=payload.get("system"),
                json_mode=payload.get("format") == "json", **kwargs)
        if path == "/api/chat":
            return self.llm.chat(payload.get("messages", []), **kwargs)
        return None

    def _handler(self):
        fake = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _send(self, obj, code=200):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self):
                fake.paths.append(self.path)
                n = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(n) or b"{}")
                resp = fake._answer(self.path, payload)
                if resp is None:
                    self._send({}, 404)
                elif resp.error:
                    self._send({"error": resp.error}, 500)
                elif self.path == "/api/generate":
                    self._send({"model": resp.model, "response": resp.text,
                                "done": True})
                else:
                    self._send({"model": resp.model, "done": True,
                                "message": {"role": "assistant",
                                            "content": resp.text}})

        return Handler
