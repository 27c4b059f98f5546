#!/usr/bin/env python
"""FastAPI speculative-serving endpoint of the port (mirror of
``inference/entrypoint/fastapi_specinfer.py``): an LLM with one draft model
(``FF_SSM_DIRS``) through the background ``SpecRequestManager``. Needs
``fastapi``, ``pydantic`` and ``uvicorn``.

    FF_MODEL_DIR=... FF_SSM_DIRS=... python -m flexflow_tpu_torch.inference.entrypoint.fastapi_specinfer
"""

from __future__ import annotations

import os

from flexflow_tpu_torch.inference.entrypoint import fastapi_incr


def create_app(llm=None):
    return fastapi_incr.create_app(llm, ssms=True)


if __name__ == "__main__":
    import uvicorn

    uvicorn.run(create_app(), host="0.0.0.0", port=int(os.environ.get("PORT", 8000)))
