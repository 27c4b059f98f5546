#!/usr/bin/env python
"""FastAPI serving endpoint of the port (mirror of
``inference/entrypoint/fastapi_incr.py``). Needs ``fastapi``, ``pydantic``
and ``uvicorn``, imported when the app is built; ``http_server.py`` is the
stdlib-only endpoint.

    FF_MODEL_DIR=... python -m flexflow_tpu_torch.inference.entrypoint.fastapi_incr
"""

from __future__ import annotations

import os


def _result(res) -> dict:
    return {"prompt": res.prompt, "output": res.output_text,
            "output_tokens": res.output_tokens, "decoding_steps": res.decoding_steps,
            "ttft_ms": res.ttft_ms, "latency_ms": res.latency_ms}


def create_app(llm=None, ssms: bool = False):
    """The app over ``llm`` (default: ``FF_MODEL_DIR``, with the drafts of
    ``FF_SSM_DIRS`` when ``ssms``), its background server started."""
    from fastapi import FastAPI
    from pydantic import BaseModel

    app = FastAPI(title="flexflow_tpu_torch " + ("speculative serving" if ssms else "serving"))
    if llm is None:
        from flexflow_tpu_torch.serve import LLM, SSM

        device = os.environ.get("FF_DEVICE")
        llm = LLM(os.environ["FF_MODEL_DIR"], device=device)
        drafts = ([SSM(d, device=device) for d in os.environ["FF_SSM_DIRS"].split(",")
                   if d.strip()] if ssms else [])
        llm.compile(max_requests_per_batch=int(os.environ.get("FF_MAX_BATCH", 8)),
                    max_seq_length=int(os.environ.get("FF_MAX_SEQ", 256)), ssms=drafts)
    llm.start_server()

    class PromptRequest(BaseModel):
        prompt: str
        max_new_tokens: int = 128
        temperature: float = 0.0
        top_p: float = 1.0
        top_k: int = 0

    @app.post("/generate")
    def generate(req: PromptRequest):
        [res] = llm.generate(req.prompt, max_new_tokens=req.max_new_tokens,
                             temperature=req.temperature, top_p=req.top_p, top_k=req.top_k)
        return _result(res)

    @app.get("/health")
    def health():
        return {"status": "ok"}

    return app


if __name__ == "__main__":
    import uvicorn

    uvicorn.run(create_app(), host="0.0.0.0", port=8000)
