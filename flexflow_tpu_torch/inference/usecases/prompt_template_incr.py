#!/usr/bin/env python
"""Prompt-template usecase over incremental decoding (mirror of
``inference/usecases/prompt_template_incr.py``): background-serve an LLM,
wrap it for LangChain and answer a templated question through a chain
(LangChain when installed, else the stdlib stand-ins).

    FF_MODEL_DIR=/path/to/model python -m flexflow_tpu_torch.inference.usecases.prompt_template_incr
"""

import os

from flexflow_tpu_torch.inference.usecases.langchain_support import (
    FlexFlowLLMWrapper, make_chain, make_langchain_llm, make_prompt_template,
)


def build_chain(llm=None, max_new_tokens=64):
    if llm is None:
        from flexflow_tpu_torch.serve import LLM

        llm = LLM(os.environ["FF_MODEL_DIR"], device=os.environ.get("FF_DEVICE"))
        llm.compile(max_requests_per_batch=int(os.environ.get("FF_MAX_BATCH", 4)),
                    max_seq_length=int(os.environ.get("FF_MAX_SEQ", 256)))
    llm.start_server()
    wrapper = make_langchain_llm(FlexFlowLLMWrapper(llm, max_new_tokens=max_new_tokens))
    prompt = make_prompt_template("Question: {question}\nAnswer:", ["question"])
    return make_chain(wrapper, prompt), llm


def main():
    chain, llm = build_chain()
    question = os.environ.get(
        "FF_QUESTION", "Who was the US president in the year of the first moon landing?")
    print(chain.run(question=question))
    llm.stop_server()


if __name__ == "__main__":
    main()
