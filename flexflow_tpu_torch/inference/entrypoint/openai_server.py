#!/usr/bin/env python
"""OpenAI-compatible serving endpoint of the port (stdlib only; mirror of
``inference/entrypoint/openai_server.py``).

``GET /v1/models``, ``/health`` and ``/healthz``; ``POST /v1/completions``
and ``/v1/chat/completions`` (``stream: true`` as server-sent events, ``n``
choices, ``stop`` and ``stop_token_ids``) over an ``LLM`` whose background
server batches the concurrent requests. A prompt given as token ids is
served as given. Errors are JSON: 400 for bad JSON, an oversize prompt or a
stop string of more than one token; 404 for an unknown path; 503 when the
serving loop has died; 500 for anything else.

    FF_MODEL_DIR=/path/to/model python -m flexflow_tpu_torch.inference.entrypoint.openai_server

``FF_MAX_BATCH``, ``FF_MAX_SEQ`` and ``FF_PORT`` size and place it;
``FF_DEVICE=cpu`` runs it on the CPU (default: the GPU).
"""

from __future__ import annotations

import json
import os
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


def _chat_to_prompt(messages):
    """Minimal chat templating: ``role: content`` lines, then ``assistant:``."""
    parts = [f"{m.get('role', 'user')}: {m.get('content', '')}" for m in messages]
    parts.append("assistant:")
    return "\n".join(parts)


def _stop_token_ids(llm, req):
    """The OpenAI ``stop`` strings as token ids, plus ``stop_token_ids``.
    A stop string must be one token: longer ones raise ``ValueError`` (a
    400) rather than being ignored."""
    ids = list(req.get("stop_token_ids", []))
    stop = req.get("stop")
    if stop is None:
        return ids
    if isinstance(stop, str):
        stop = [stop]
    for s in stop:
        toks = llm.tokenizer(s, return_tensors=None)["input_ids"]
        if len(toks) != 1:
            raise ValueError(f"stop sequence {s!r} tokenizes to {len(toks)} tokens; "
                             "only single-token stop strings are supported")
        ids.append(int(toks[0]))
    return ids


def _prompt(req, chat: bool):
    """The request's prompt: the templated chat, a string, or token ids."""
    if chat:
        return _chat_to_prompt(req.get("messages", []))
    prompt = req.get("prompt", "")
    if isinstance(prompt, list) and not (prompt and isinstance(prompt[0], int)):
        return prompt[0] if prompt else ""
    return prompt


def _sampling(llm, req) -> dict:
    return dict(max_new_tokens=int(req.get("max_tokens", 128)),
                temperature=float(req.get("temperature", 0.0)),
                top_p=float(req.get("top_p", 1.0)), top_k=int(req.get("top_k", 0)),
                stop_token_ids=_stop_token_ids(llm, req))


def make_handler(llm, model_name: str):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _json(self, code, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/v1/models":
                self._json(200, {"object": "list", "data": [
                    {"id": model_name, "object": "model"}]})
            elif self.path in ("/health", "/healthz"):
                self._json(200, {"status": "ok"})
            else:
                self._json(404, {"error": {"message": "not found"}})

        def _stream(self, gen, chat):
            """Server-sent events over ``LLM.generate_stream``: one chunk a
            text delta, a last chunk with the finish reason ("error" when
            the serving loop died), then ``data: [DONE]``."""
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.end_headers()
            rid = f"cmpl-{uuid.uuid4().hex[:24]}"
            created = int(time.time())
            obj = "chat.completion.chunk" if chat else "text_completion"

            def emit(delta, finish=None):
                if chat:
                    choice = {"index": 0, "finish_reason": finish,
                              "delta": {"role": "assistant", "content": delta} if delta else {}}
                else:
                    choice = {"index": 0, "text": delta, "finish_reason": finish,
                              "logprobs": None}
                chunk = {"id": rid, "object": obj, "created": created, "model": model_name,
                         "choices": [choice]}
                self.wfile.write(b"data: " + json.dumps(chunk).encode() + b"\n\n")
                self.wfile.flush()

            try:
                for delta in gen:
                    emit(delta)
            except RuntimeError:  # the serving loop died mid-stream
                emit("", finish="error")
            else:
                emit("", finish="stop")
            self.wfile.write(b"data: [DONE]\n\n")
            self.wfile.flush()

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            try:
                req = json.loads(self.rfile.read(n) or b"{}")
            except json.JSONDecodeError:
                return self._json(400, {"error": {"message": "bad json"}})
            chat = self.path == "/v1/chat/completions"
            if self.path not in ("/v1/completions", "/v1/chat/completions"):
                return self._json(404, {"error": {"message": "not found"}})

            try:
                prompt = _prompt(req, chat)
                if req.get("stream"):
                    # generate_stream registers at once: an oversize prompt is
                    # a 400 here, not a broken stream
                    return self._stream(llm.generate_stream(prompt, **_sampling(llm, req)),
                                        chat)
                # with the background server running, generate() only
                # registers and waits: concurrent requests share the batch
                results = llm.generate([prompt] * max(1, int(req.get("n", 1))),
                                       **_sampling(llm, req))
            except ValueError as e:  # oversize prompt, bad stop, ...
                return self._json(400, {"error": {"message": str(e)}})
            except RuntimeError as e:  # the serving loop died
                return self._json(503, {"error": {"message": str(e)}})
            except Exception as e:  # anything else: a JSON 500, not a dropped connection
                return self._json(500, {"error": {"message": f"{type(e).__name__}: {e}"}})

            n_prompt = len(llm._token_ids(prompt))
            n_out = sum(len(r.output_tokens) for r in results)
            usage = {"prompt_tokens": n_prompt, "completion_tokens": n_out,
                     "total_tokens": n_prompt + n_out}
            rid = f"cmpl-{uuid.uuid4().hex[:24]}"
            created = int(time.time())
            if chat:
                self._json(200, {
                    "id": rid, "object": "chat.completion", "created": created,
                    "model": model_name,
                    "choices": [{"index": i, "finish_reason": "stop",
                                 "message": {"role": "assistant", "content": r.output_text}}
                                for i, r in enumerate(results)],
                    "usage": usage})
            else:
                self._json(200, {
                    "id": rid, "object": "text_completion", "created": created,
                    "model": model_name,
                    "choices": [{"index": i, "text": r.output_text, "finish_reason": "stop",
                                 "logprobs": None} for i, r in enumerate(results)],
                    "usage": usage})

    return Handler


def serve(llm=None, host: str = "0.0.0.0", port: int = 8000,
          model_name: str = "flexflow-tpu-torch"):
    """Serve ``llm`` (default: an ``LLM`` of ``FF_MODEL_DIR``, compiled for
    ``FF_MAX_BATCH`` requests of ``FF_MAX_SEQ`` tokens on ``FF_DEVICE``)
    until interrupted; the background server stops on the way out."""
    if llm is None:
        from flexflow_tpu_torch.serve import LLM

        model_dir = os.environ["FF_MODEL_DIR"]
        model_name = os.path.basename(model_dir.rstrip("/")) or model_name
        llm = LLM(model_dir, device=os.environ.get("FF_DEVICE"))
        llm.compile(max_requests_per_batch=int(os.environ.get("FF_MAX_BATCH", 8)),
                    max_seq_length=int(os.environ.get("FF_MAX_SEQ", 256)))
    llm.start_server()
    srv = ThreadingHTTPServer((host, port), make_handler(llm, model_name))
    print(f"OpenAI-compatible server on http://{host}:{port}/v1")
    try:
        srv.serve_forever()
    finally:
        srv.server_close()
        llm.stop_server()


if __name__ == "__main__":
    serve(port=int(os.environ.get("FF_PORT", 8000)))
