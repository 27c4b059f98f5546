#!/usr/bin/env python
"""Retrieval-augmented generation over incremental decoding (mirror of
``inference/usecases/rag_incr.py``): retrieve the document chunks that best
match the question, put them in the prompt and answer with the
background-served LLM (a LangChain chain when installed, else the stdlib
stand-ins; the token-overlap retriever either way).

    FF_MODEL_DIR=... FF_DOCS=/path/a.txt,/path/b.txt python -m flexflow_tpu_torch.inference.usecases.rag_incr
"""

import os

from flexflow_tpu_torch.inference.usecases.langchain_support import (
    FlexFlowLLMWrapper, TokenOverlapRetriever, make_chain, make_langchain_llm,
    make_prompt_template,
)

RAG_TEMPLATE = (
    "Use the following context to answer the question.\n"
    "Context:\n{context}\n\nQuestion: {question}\nAnswer:"
)


def build_rag(llm=None, docs=None, max_new_tokens=64):
    if llm is None:
        from flexflow_tpu_torch.serve import LLM

        llm = LLM(os.environ["FF_MODEL_DIR"], device=os.environ.get("FF_DEVICE"))
        llm.compile(max_requests_per_batch=int(os.environ.get("FF_MAX_BATCH", 4)),
                    max_seq_length=int(os.environ.get("FF_MAX_SEQ", 512)))
    llm.start_server()
    if docs is None:
        docs = []
        for path in os.environ.get("FF_DOCS", "").split(","):
            if path.strip():
                with open(path) as f:
                    docs.append(f.read())
    retriever = TokenOverlapRetriever(docs)
    wrapper = make_langchain_llm(FlexFlowLLMWrapper(llm, max_new_tokens=max_new_tokens))
    chain = make_chain(wrapper, make_prompt_template(RAG_TEMPLATE, ["context", "question"]))

    def answer(question: str, k: int = 2) -> str:
        context = "\n---\n".join(retriever.retrieve(question, k))
        return chain.run(context=context, question=question)

    return answer, llm


def main():
    answer, llm = build_rag()
    print(answer(os.environ.get("FF_QUESTION", "What does the document say?")))
    llm.stop_server()


if __name__ == "__main__":
    main()
