#!/usr/bin/env python
"""Prompt-template usecase over speculative decoding (mirror of
``inference/usecases/prompt_template_specinfer.py``): the same chain served
by an LLM with one or more draft models (comma-separated in ``FF_SSM_DIRS``)
through the background speculative manager.

    FF_MODEL_DIR=... FF_SSM_DIRS=... python -m flexflow_tpu_torch.inference.usecases.prompt_template_specinfer
"""

import os

from flexflow_tpu_torch.inference.usecases.langchain_support import (
    FlexFlowLLMWrapper, make_chain, make_langchain_llm, make_prompt_template,
)


def build_chain(llm=None, max_new_tokens=64):
    if llm is None:
        from flexflow_tpu_torch.serve import LLM, SSM

        device = os.environ.get("FF_DEVICE")
        llm = LLM(os.environ["FF_MODEL_DIR"], device=device)
        ssms = [SSM(d, device=device) for d in os.environ["FF_SSM_DIRS"].split(",")
                if d.strip()]
        llm.compile(max_requests_per_batch=int(os.environ.get("FF_MAX_BATCH", 4)),
                    max_seq_length=int(os.environ.get("FF_MAX_SEQ", 256)), ssms=ssms)
    llm.start_server()
    wrapper = make_langchain_llm(FlexFlowLLMWrapper(llm, max_new_tokens=max_new_tokens))
    prompt = make_prompt_template("Question: {question}\nAnswer:", ["question"])
    return make_chain(wrapper, prompt), llm


def main():
    chain, llm = build_chain()
    print(chain.run(question=os.environ.get("FF_QUESTION", "What is a GPU?")))
    llm.stop_server()


if __name__ == "__main__":
    main()
