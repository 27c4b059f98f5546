#!/usr/bin/env python
"""Retrieval-augmented generation over speculative decoding (mirror of
``inference/usecases/rag_specinfer.py``): the ``rag_incr`` recipe served by
an LLM with one draft model.

    FF_MODEL_DIR=... FF_SSM_DIRS=... FF_DOCS=... python -m flexflow_tpu_torch.inference.usecases.rag_specinfer
"""

import os

from flexflow_tpu_torch.inference.usecases.rag_incr import build_rag


def build_rag_spec(docs=None, max_new_tokens=64):
    from flexflow_tpu_torch.serve import LLM, SSM

    device = os.environ.get("FF_DEVICE")
    llm = LLM(os.environ["FF_MODEL_DIR"], device=device)
    ssms = [SSM(d, device=device) for d in os.environ["FF_SSM_DIRS"].split(",") if d.strip()]
    llm.compile(max_requests_per_batch=int(os.environ.get("FF_MAX_BATCH", 4)),
                max_seq_length=int(os.environ.get("FF_MAX_SEQ", 512)), ssms=ssms)
    return build_rag(llm=llm, docs=docs, max_new_tokens=max_new_tokens)


def main():
    answer, llm = build_rag_spec()
    print(answer(os.environ.get("FF_QUESTION", "What does the document say?")))
    llm.stop_server()


if __name__ == "__main__":
    main()
