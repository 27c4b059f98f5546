#!/usr/bin/env python
"""Dependency-free HTTP serving endpoint of the port (stdlib ``http.server``;
mirror of ``inference/entrypoint/http_server.py``).

``POST /generate`` (or ``/v1/generate``) with ``{"prompt": str,
"max_new_tokens": int, "temperature": float, "top_p": float, "top_k": int}``
returns ``{"prompt", "output", "output_tokens", "decoding_steps", "ttft_ms",
"latency_ms"}``; ``GET /health`` returns ``ok``. The requests of concurrent
callers share the batch of the LLM's background server. Over an ``LLM``
compiled on a mesh only rank 0 binds the port; the other ranks serve its
requests in step until rank 0 stops its server.

    python -m flexflow_tpu_torch.inference.entrypoint.http_server -llm-model DIR --port 8080
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from flexflow_tpu_torch.parallel.distributed import is_controller


def make_handler(llm):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet
            pass

        def do_POST(self):
            if self.path not in ("/generate", "/v1/generate"):
                self.send_error(404)
                return
            length = int(self.headers.get("Content-Length", 0))
            try:
                body = json.loads(self.rfile.read(length) or b"{}")
                [res] = llm.generate(
                    body.get("prompt", ""),
                    max_new_tokens=int(body.get("max_new_tokens", 128)),
                    temperature=float(body.get("temperature", 0.0)),
                    top_p=float(body.get("top_p", 1.0)),
                    top_k=int(body.get("top_k", 0)),
                )
                payload = {
                    "prompt": res.prompt,
                    "output": res.output_text,
                    "output_tokens": res.output_tokens,
                    "decoding_steps": res.decoding_steps,
                    "ttft_ms": res.ttft_ms,
                    "latency_ms": res.latency_ms,
                }
                data = json.dumps(payload).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
            except Exception as e:  # noqa: BLE001
                self.send_error(500, str(e))

        def do_GET(self):
            if self.path == "/health":
                self.send_response(200)
                self.send_header("Content-Length", "2")
                self.end_headers()
                self.wfile.write(b"ok")
            else:
                self.send_error(404)

    return Handler


def serve(llm, host: str = "127.0.0.1", port: int = 8080) -> Optional[ThreadingHTTPServer]:
    """Start ``llm``'s background server and an HTTP server on a daemon
    thread; returns the HTTP server (``shutdown()`` it, then
    ``llm.stop_server()``). Under a mesh a rank other than 0 binds nothing:
    it serves in step, returns ``None`` once rank 0's ``stop_server`` has
    run."""
    llm.start_server()
    if llm.mesh is not None and not is_controller():
        llm.stop_server()  # a follower's returns once rank 0's loop has stopped
        return None
    server = ThreadingHTTPServer((host, port), make_handler(llm))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("-llm-model", "--llm-model", dest="model", required=True)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--max-requests-per-batch", type=int, default=8)
    p.add_argument("--max-sequence-length", type=int, default=256)
    p.add_argument("--full-precision", action="store_true")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args, _ = p.parse_known_args(argv)

    from flexflow_tpu_torch.serve import LLM

    llm = LLM(args.model, data_type="float32" if args.full_precision else "bfloat16",
              device=args.device)
    llm.compile(max_requests_per_batch=args.max_requests_per_batch,
                max_seq_length=args.max_sequence_length)
    llm.start_server()
    server = ThreadingHTTPServer((args.host, args.port), make_handler(llm))
    print(f"serving on http://{args.host}:{args.port}")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        llm.stop_server()
    return 0


if __name__ == "__main__":
    sys.exit(main())
