"""LangChain integration and stdlib stand-ins shared by the port's usecase
recipes (mirror of ``inference/usecases/langchain_support.py``).

When ``langchain`` is installed, :func:`make_langchain_llm`,
:func:`make_prompt_template` and :func:`make_chain` return its objects;
otherwise the stand-ins below give the same surface (``format``,
``chain.run``) with the standard library, so the recipes run, and are
tested, without it.
"""

from __future__ import annotations

import re
from typing import List, Optional, Sequence


class SimplePromptTemplate:
    """Stdlib stand-in for ``langchain.prompts.PromptTemplate``."""

    def __init__(self, template: str, input_variables: Sequence[str]):
        self.template = template
        self.input_variables = list(input_variables)

    def format(self, **kw) -> str:
        return self.template.format(**kw)


class SimpleChain:
    """Stdlib stand-in for ``langchain.chains.LLMChain``."""

    def __init__(self, llm, prompt: SimplePromptTemplate):
        self.llm = llm
        self.prompt = prompt

    def run(self, **kw) -> str:
        return self.llm(self.prompt.format(**kw))


class FlexFlowLLMWrapper:
    """Callable wrapper over ``flexflow_tpu_torch.serve.LLM``: standalone,
    and the ``_call`` body of a LangChain LLM. ``stop`` strings cut the
    text at their first occurrence."""

    def __init__(self, llm, *, max_new_tokens: int = 128,
                 temperature: float = 0.0, top_p: float = 1.0):
        self.llm = llm
        self.max_new_tokens = max_new_tokens
        self.temperature = temperature
        self.top_p = top_p

    def __call__(self, prompt: str, stop: Optional[Sequence[str]] = None) -> str:
        [res] = self.llm.generate(prompt, max_new_tokens=self.max_new_tokens,
                                  temperature=self.temperature, top_p=self.top_p)
        text = res.output_text
        for s in stop or ():
            idx = text.find(s)
            if idx >= 0:
                text = text[:idx]
        return text


def make_langchain_llm(wrapper: FlexFlowLLMWrapper):
    """A LangChain LLM over ``wrapper`` when langchain is installed; the
    wrapper itself otherwise."""
    try:
        from langchain.llms.base import LLM as LangchainLLM
    except ImportError:
        return wrapper

    class FF_LLM_wrapper(LangchainLLM):
        @property
        def _llm_type(self) -> str:
            return "flexflow_tpu_torch"

        def _call(self, prompt: str, stop=None, run_manager=None, **kw) -> str:
            return wrapper(prompt, stop)

    return FF_LLM_wrapper()


def make_prompt_template(template: str, input_variables: Sequence[str]):
    try:
        from langchain.prompts import PromptTemplate

        return PromptTemplate(template=template, input_variables=list(input_variables))
    except ImportError:
        return SimplePromptTemplate(template, input_variables)


def make_chain(llm, prompt):
    try:
        from langchain.chains import LLMChain

        return LLMChain(llm=llm, prompt=prompt)
    except (ImportError, TypeError):
        return SimpleChain(llm, prompt)


class TokenOverlapRetriever:
    """Dependency-free retriever for the RAG recipes: ranks text chunks by
    how many lower-case alphanumeric words they share with the query (ties
    keep document order)."""

    def __init__(self, docs: Sequence[str], chunk_chars: int = 400):
        self.chunks: List[str] = []
        for doc in docs:
            for i in range(0, len(doc), chunk_chars):
                chunk = doc[i:i + chunk_chars].strip()
                if chunk:
                    self.chunks.append(chunk)

    @staticmethod
    def _tokens(text: str):
        return set(re.findall(r"[a-z0-9]+", text.lower()))

    def retrieve(self, query: str, k: int = 2) -> List[str]:
        q = self._tokens(query)
        return sorted(self.chunks, key=lambda c: -len(q & self._tokens(c)))[:k]
