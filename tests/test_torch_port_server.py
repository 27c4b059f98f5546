"""The port's serving surface against the JAX package's, on the CPU at
float32: a tiny HF LLaMA directory (2 layers, d 64, a character-level
tokenizer; built in-process, nothing downloaded) served by JAX's
``LLM(..., data_type="float32")`` and the port's
``LLM(..., data_type="float32", device="cpu")`` side by side.

- ``generate_stream``: the deltas join to ``generate``'s text, which equals
  JAX's;
- the OpenAI endpoint: the same requests to JAX's handler over JAX's LLM and
  to the port's over the port's give the same status codes, ``choices``
  text and ``usage`` (``id`` and ``created`` aside), streamed too;
- the stdlib HTTP endpoint, the chat CLI and the prompt-template and RAG
  chains give JAX's text; the retriever ranks as JAX's does;
- the background server: concurrent callers get the tokens of sequential
  calls, a dying loop fails its waiters (``RuntimeError``, an SSE
  ``"error"`` finish, a 503) as in JAX, restarts are harmless, and the
  speculative manager serves in the background;
- ``--profiling`` prints JAX's phase and per-op row names;
- the mirrors of optional packages import without them.
"""

import builtins
import json
import re
import sys
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from flexflow_tpu.serve import LLM as JLLM  # noqa: E402
from flexflow_tpu_torch.serve import LLM as TLLM  # noqa: E402
from flexflow_tpu_torch.serve import SSM as TSSM  # noqa: E402

torch.set_num_threads(2)

MAX_SEQ = 128  # room for the RAG prompt (one token a character)


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    from tokenizers import Tokenizer
    from tokenizers import models as tok_models

    d = tmp_path_factory.mktemp("tiny_llama_server")
    torch.manual_seed(0)
    cfg = transformers.LlamaConfig(vocab_size=128, hidden_size=64, intermediate_size=128,
                                   num_hidden_layers=2, num_attention_heads=4,
                                   num_key_value_heads=4, max_position_embeddings=128)
    cfg.architectures = ["LlamaForCausalLM"]
    transformers.LlamaForCausalLM(cfg).save_pretrained(d, safe_serialization=True)
    vocab = {chr(i): (i - 32) for i in range(32, 127)}
    vocab["<unk>"] = len(vocab)
    Tokenizer(tok_models.BPE(vocab=vocab, merges=[], unk_token="<unk>")).save(
        str(d / "tokenizer.json"))
    with open(d / "tokenizer_config.json", "w") as f:
        json.dump({"tokenizer_class": "PreTrainedTokenizerFast"}, f)
    return str(d)


def _compile(model_dir, jax_side: bool, slots: int = 2):
    llm = (JLLM(model_dir, data_type="float32") if jax_side
           else TLLM(model_dir, data_type="float32", device="cpu"))
    llm.compile(max_requests_per_batch=slots, max_seq_length=MAX_SEQ)
    return llm


def _http(llm, handler):
    srv = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


@pytest.fixture(scope="module")
def pair(model_dir):
    """(JAX LLM, port LLM), each with its background server running."""
    jllm, tllm = _compile(model_dir, True), _compile(model_dir, False)
    jllm.start_server()
    tllm.start_server()
    yield jllm, tllm
    jllm.stop_server()
    tllm.rm.close()


@pytest.fixture(scope="module")
def openai_ports(pair):
    """The OpenAI handlers of both packages over the pair, on loopback."""
    from flexflow_tpu_torch.inference.entrypoint import openai_server as t_openai
    from inference.entrypoint import openai_server as j_openai

    srvs = [_http(llm, mod.make_handler(llm, "tiny-llama"))
            for llm, mod in zip(pair, (j_openai, t_openai))]
    yield [s.server_address[1] for s in srvs]
    for s in srvs:
        s.shutdown()
        s.server_close()


def _request(port, path, body=None, raw=None):
    """(status, body): JSON, or the raw text of an event stream."""
    data = raw if raw is not None else (None if body is None else json.dumps(body).encode())
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            text = r.read().decode()
            if r.headers["Content-Type"].startswith("text/event-stream"):
                return r.status, text
            return r.status, json.loads(text)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _comparable(status, body):
    """What must agree between the packages: the status and, for JSON, the
    body without ``id`` / ``created``; for a stream, the joined text and the
    last finish reason."""
    if isinstance(body, str):
        events = [ln[6:] for ln in body.splitlines() if ln.startswith("data: ")]
        chunks = [json.loads(e) for e in events[:-1]]
        text = "".join(c["choices"][0].get("text", c["choices"][0].get("delta", {}).get(
            "content", "")) for c in chunks)
        return status, events[-1], text, chunks[-1]["choices"][0]["finish_reason"]
    return status, {k: v for k, v in body.items() if k not in ("id", "created")}


HELLO = "hello world"
OPENAI_CASES = {
    "completion": ("/v1/completions", {"prompt": HELLO, "max_tokens": 8}),
    "chat": ("/v1/chat/completions", {"messages": [{"role": "user", "content": "hi"}],
                                      "max_tokens": 6}),
    "n2": ("/v1/completions", {"prompt": "abc", "max_tokens": 5, "n": 2}),
    "stream": ("/v1/completions", {"prompt": HELLO, "max_tokens": 8, "stream": True}),
    "stream_chat": ("/v1/chat/completions", {"messages": [{"role": "user", "content": "yo"}],
                                             "max_tokens": 6, "stream": True}),
    "stop_single_token": ("/v1/completions", {"prompt": HELLO, "max_tokens": 12, "stop": "e",
                                              "stop_token_ids": [5]}),
    "stop_multi_token": ("/v1/completions", {"prompt": "hi", "max_tokens": 4,
                                             "stop": ["hello world"]}),
    "oversize_prompt": ("/v1/completions", {"prompt": "x " * 200, "max_tokens": 4}),
    "oversize_stream": ("/v1/completions", {"prompt": "x " * 200, "max_tokens": 4,
                                            "stream": True}),
    "unknown_path": ("/v1/embeddings", {"input": "x"}),
}


@pytest.mark.parametrize("case", list(OPENAI_CASES))
def test_openai_endpoint_matches_jax(openai_ports, case):
    path, body = OPENAI_CASES[case]
    if case == "oversize_stream":
        # JAX registers a stream lazily: its oversize stream breaks after the
        # 200; the port registers first and answers 400, as without stream
        got = _request(openai_ports[1], path, body)
        assert got[0] == 400 and "max_seq_len" in got[1]["error"]["message"]
        return
    want = _comparable(*_request(openai_ports[0], path, body))
    got = _comparable(*_request(openai_ports[1], path, body))
    assert got == want
    if case in ("completion", "chat", "n2", "stop_single_token"):
        assert got[0] == 200 and got[1]["choices"][0]
    if case in ("stream", "stream_chat"):
        assert got[1] == "[DONE]" and got[2] and got[3] == "stop"
    if case == "n2":
        assert len(got[1]["choices"]) == 2 and got[1]["usage"]["completion_tokens"] == 10
    if case in ("stop_multi_token", "oversize_prompt"):
        assert got[0] == 400 and "error" in got[1]
    if case == "unknown_path":
        assert got[0] == 404


def test_openai_get_and_bad_json_match_jax(openai_ports):
    for path in ("/v1/models", "/health", "/healthz", "/nothing"):
        want, got = (_request(p, path) for p in openai_ports)
        assert got == want, path
    assert got[0] == 404
    want, got = (_request(p, "/v1/completions", raw=b"{not json") for p in openai_ports)
    assert got == want and got[0] == 400


def test_openai_token_id_prompt(pair, openai_ports):
    """Token ids are served as given: the port's answer for the ids of
    "hello world" is JAX's answer for the string. (JAX decodes the ids and
    tokenizes the text again, which this tokenizer's decode, joining tokens
    with spaces, does not invert.)"""
    ids = pair[1].tokenizer(HELLO, return_tensors=None)["input_ids"]
    want = _comparable(*_request(openai_ports[0], "/v1/completions",
                                 {"prompt": HELLO, "max_tokens": 8}))
    got = _comparable(*_request(openai_ports[1], "/v1/completions",
                                {"prompt": ids, "max_tokens": 8}))
    assert got == want and got[1]["usage"]["prompt_tokens"] == len(ids)
    jax_ids = _request(openai_ports[0], "/v1/completions", {"prompt": ids, "max_tokens": 8})[1]
    assert jax_ids["usage"]["prompt_tokens"] == 2 * len(ids) - 1
    streamed = _comparable(*_request(openai_ports[1], "/v1/completions",
                                     {"prompt": ids, "max_tokens": 8, "stream": True}))
    assert streamed[2] == got[1]["choices"][0]["text"]


def test_generate_stream_joins_to_generate_and_jax(pair):
    jllm, tllm = pair
    [want] = jllm.generate(HELLO, max_new_tokens=8)
    [res] = tllm.generate(HELLO, max_new_tokens=8)
    deltas = list(tllm.generate_stream(HELLO, max_new_tokens=8))
    assert "".join(deltas) == res.output_text == want.output_text
    assert res.output_tokens == want.output_tokens and len(res.output_tokens) == 8
    ids = tllm.tokenizer(HELLO, return_tensors=None)["input_ids"]
    assert "".join(tllm.generate_stream(ids, max_new_tokens=8)) == want.output_text


def test_http_server_matches_jax(pair):
    from flexflow_tpu_torch.inference.entrypoint import http_server as t_http
    from inference.entrypoint import http_server as j_http

    jsrv = _http(pair[0], j_http.make_handler(pair[0]))
    tsrv = t_http.serve(pair[1], port=0)
    try:
        ports = [s.server_address[1] for s in (jsrv, tsrv)]
        body = {"prompt": HELLO, "max_new_tokens": 6}
        want, got = (_request(p, "/generate", body)[1] for p in ports)
        keys = ("prompt", "output", "output_tokens", "decoding_steps")
        assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
        assert len(got["output_tokens"]) == 6 and got["latency_ms"] >= got["ttft_ms"] >= 0
        assert _request(ports[1], "/v1/generate", body)[1]["output"] == want["output"]
        with urllib.request.urlopen(f"http://127.0.0.1:{ports[1]}/health", timeout=30) as r:
            assert r.read() == b"ok"
        for p in ports:
            with pytest.raises(urllib.error.HTTPError, match="404"):
                urllib.request.urlopen(f"http://127.0.0.1:{p}/nothing", timeout=30)
    finally:
        for s in (jsrv, tsrv):
            s.shutdown()
            s.server_close()


def test_usecase_chains_match_jax(pair):
    from flexflow_tpu_torch.inference.usecases import prompt_template_incr as t_pt
    from flexflow_tpu_torch.inference.usecases import rag_incr as t_rag
    from inference.usecases import prompt_template_incr as j_pt
    from inference.usecases import rag_incr as j_rag

    jllm, tllm = pair
    want = j_pt.build_chain(llm=jllm, max_new_tokens=6)[0].run(question="what is up?")
    got = t_pt.build_chain(llm=tllm, max_new_tokens=6)[0].run(question="what is up?")
    assert got == want and len(got) > 0
    docs = ["GPUs multiply fast.", "Bananas are yellow."]
    want = j_rag.build_rag(llm=jllm, docs=docs, max_new_tokens=4)[0]("GPUs?", k=1)
    got = t_rag.build_rag(llm=tllm, docs=docs, max_new_tokens=4)[0]("GPUs?", k=1)
    assert got == want


@pytest.mark.parametrize("query,k,chunk", [
    ("how do TPUs multiply matrices", 1, 100), ("yellow fruit", 2, 100),
    ("nothing in common", 3, 100), ("bananas multiply", 2, 9)])
def test_retriever_ranks_as_jax(query, k, chunk):
    from flexflow_tpu_torch.inference.usecases.langchain_support import (
        TokenOverlapRetriever as TRetriever)
    from inference.usecases.langchain_support import TokenOverlapRetriever as JRetriever

    docs = ["TPUs multiply matrices quickly.", "Bananas are yellow fruit.",
            "Matrices of bananas, in yellow."]
    want = JRetriever(docs, chunk_chars=chunk).retrieve(query, k)
    assert TRetriever(docs, chunk_chars=chunk).retrieve(query, k) == want


def test_prompt_template_and_wrapper_stop():
    from flexflow_tpu_torch.inference.usecases import langchain_support as t_lc
    from inference.usecases import langchain_support as j_lc

    class Echo:  # an LLM whose output is its prompt
        def generate(self, prompt, **kw):
            return [type("R", (), {"output_text": prompt})()]

    for lc in (j_lc, t_lc):
        assert lc.make_langchain_llm(lc.FlexFlowLLMWrapper(Echo())).__class__.__name__ == \
            "FlexFlowLLMWrapper"
    tmpl = "Q: {q}\nA: stop here"
    outs = [lc.make_chain(lc.FlexFlowLLMWrapper(Echo()), lc.make_prompt_template(tmpl, ["q"]))
            .run(q="x") for lc in (j_lc, t_lc)]
    assert outs[0] == outs[1] == "Q: x\nA: stop here"
    assert [lc.FlexFlowLLMWrapper(Echo())("abc stop def", stop=["stop"]) for lc in (j_lc, t_lc)] \
        == ["abc ", "abc "]


def test_concurrent_generate_equals_sequential(pair):
    """Four threads call ``generate`` at once against the running server (two
    slots): each gets the tokens of a call made alone."""
    tllm = pair[1]
    prompts = ["hello", "abc def", "the quick brown fox", "x"]
    want = [tllm.generate(p, max_new_tokens=10)[0].output_tokens for p in prompts]
    got = [None] * len(prompts)

    def call(i):
        got[i] = tllm.generate(prompts[i], max_new_tokens=10)[0].output_tokens

    threads = [threading.Thread(target=call, args=(i,)) for i in range(len(prompts))]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # switch threads often: registration races the loop
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert got == want


def test_restart_and_in_process_generate(pair):
    """``start_server`` twice is harmless; after ``stop_server`` an
    in-process ``generate`` serves (as in JAX), and the server restarts."""
    jllm, tllm = pair
    for llm in pair:
        thread = llm.rm._server_thread
        llm.start_server()
        assert llm.rm._server_thread is thread and thread.is_alive()
    try:
        for llm in pair:
            thread = llm.rm._server_thread
            llm.stop_server()
            assert llm.rm._server_thread is None and not thread.is_alive()
        want = jllm.generate("abc", max_new_tokens=6)[0].output_tokens
        got = tllm.generate("abc", max_new_tokens=6)[0].output_tokens
        assert got == want and len(got) == 6
        assert not tllm.rm._inflight_q and not any(tllm.rm._slots)
        with pytest.raises(RuntimeError, match="start_server"):
            tllm.generate_stream("abc", max_new_tokens=2)
    finally:
        for llm in pair:
            llm.start_server()
    assert tllm.generate("abc", max_new_tokens=6)[0].output_tokens == got


def _fail_next_decode(llm):
    """Make the engine's next decode dispatch raise, once (patched on the
    instance), after the manager has drained what it held."""
    rm = llm.rm
    deadline = time.monotonic() + 60
    while (any(rm._slots) or rm._inflight_q) and time.monotonic() < deadline:
        time.sleep(0.01)
    decode = type(rm.engine).decode_horizon_async.__get__(rm.engine)

    def boom(*a, **kw):
        rm.engine.decode_horizon_async = decode
        raise RuntimeError("injected decode failure")

    rm.engine.decode_horizon_async = boom


# the loop re-raises its error on its thread after failing the waiters
@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_dying_loop_fails_its_waiters_as_in_jax(model_dir):
    """A loop that raises fails the requests in flight: ``generate`` raises
    ``RuntimeError``, a stream ends with finish reason "error" and
    ``[DONE]``, a completion gets a 503, in both packages (the server
    restarted between the cases). The port also refuses a request made
    after the loop died, where JAX's would wait for ever, and its restarted
    loop leaves the failed requests FAILED (JAX's finishes decoding them)."""
    from flexflow_tpu_torch.inference.entrypoint import openai_server as t_openai
    from inference.entrypoint import openai_server as j_openai

    llms = [_compile(model_dir, True), _compile(model_dir, False)]
    srvs = [_http(llm, mod.make_handler(llm, "m"))
            for llm, mod in zip(llms, (j_openai, t_openai))]
    ports = [s.server_address[1] for s in srvs]
    stream = {"prompt": "abc", "max_tokens": 4, "stream": True}
    try:
        for llm in llms:
            llm.start_server()
            _fail_next_decode(llm)
            with pytest.raises(RuntimeError, match="serving loop failed.*injected"):
                llm.generate("abc", max_new_tokens=4)
            llm.rm._server_thread.join(timeout=60)  # the loop re-raises and ends
            assert not llm.rm._server_thread.is_alive()
        with pytest.raises(RuntimeError, match="serving loop failed.*injected"):
            llms[1].generate("abc", max_new_tokens=4)
        assert _request(ports[1], "/v1/completions", {"prompt": "abc"})[0] == 503
        assert _request(ports[1], "/v1/completions", stream)[0] == 503
        streams, codes = [], []
        for llm, port in zip(llms, ports):
            llm.stop_server()
            llm.start_server()
            _fail_next_decode(llm)
            streams.append(_comparable(*_request(port, "/v1/completions", stream)))
            llm.stop_server()
            llm.start_server()
            _fail_next_decode(llm)
            codes.append(_request(port, "/v1/completions", {"prompt": "abc", "max_tokens": 4}))
        assert streams[0] == streams[1] and streams[1][1:] == ("[DONE]", "", "error")
        assert [c[0] for c in codes] == [503, 503]
        assert all("injected" in c[1]["error"]["message"] for c in codes)
        llms[1].stop_server()
        llms[1].start_server()
        [res] = llms[1].generate("abc", max_new_tokens=4)
        assert len(res.output_tokens) == 4
        states = [r.state for r in llms[1].rm._requests.values()]
        assert states.count("FAILED") == 3 and states.count("COMPLETED") == 1
    finally:
        for s in srvs:
            s.shutdown()
            s.server_close()
        for llm in llms:
            llm.stop_server()
        llms[1].rm.close()


def test_spec_background_server(model_dir, pair):
    """The speculative manager serves in the background (the recipe of
    ``tests/test_entrypoints.py::test_spec_background_server``): concurrent
    callers get incremental decoding's tokens."""
    llm = TLLM(model_dir, data_type="float32", device="cpu")
    llm.compile(max_requests_per_batch=2, max_seq_length=64,
                ssms=[TSSM(model_dir, data_type="float32", device="cpu")],
                beam_width=2, beam_depth=3)
    prompts = ["hello", "abc", "xyz"]
    want = [pair[1].generate(p, max_new_tokens=8)[0].output_tokens for p in prompts]
    llm.start_server()
    try:
        got = [None] * 3

        def call(i):
            got[i] = llm.generate(prompts[i], max_new_tokens=8)[0].output_tokens

        threads = [threading.Thread(target=call, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        assert got == want and all(len(t) == 8 for t in got)
        assert "".join(llm.generate_stream("hello", max_new_tokens=8)) == \
            llm.tokenizer.decode(want[0], skip_special_tokens=True)
        from flexflow_tpu_torch.inference.usecases import prompt_template_incr as t_pt
        from flexflow_tpu_torch.inference.usecases import prompt_template_specinfer as t_pts

        chain = t_pts.build_chain(llm=llm, max_new_tokens=6)[0]
        assert chain.run(question="what is up?") == \
            t_pt.build_chain(llm=pair[1], max_new_tokens=6)[0].run(question="what is up?")
    finally:
        llm.stop_server()
    assert not llm.rm._server_thread


def _phase_names(out: str):
    return sorted(set(re.findall(r"^\[Profile\] (\w+): total", out, re.MULTILINE)))


def _op_rows(out: str):
    return re.findall(r"^\[Profile\] (.+?)(?: forward time = |: skipped)", out, re.MULTILINE)


def test_profiling_reports_jax_phases_and_ops(monkeypatch, capsys):
    """``--profiling``: the incremental and speculative managers print the
    JAX package's phase names for the same run, and the incremental one the
    per-op rows of JAX's ``per_op_profile`` once."""
    import jax
    import jax.numpy as jnp

    from flexflow_tpu import config as j_config
    from flexflow_tpu import specs as jspecs
    from flexflow_tpu.models import params as jp
    from flexflow_tpu.serving import GenerationConfig as JGen
    from flexflow_tpu.serving.engine import InferenceEngine as JEngine
    from flexflow_tpu.serving.request_manager import RequestManager as JRM
    from flexflow_tpu.serving.spec_manager import SpecRequestManager as JSRM
    from flexflow_tpu.serving.speculative import SpecEngine as JSpecEngine
    from flexflow_tpu.utils.profiling import per_op_profile as j_per_op
    from flexflow_tpu_torch import config as t_config
    from flexflow_tpu_torch import specs as tspecs
    from flexflow_tpu_torch.models import params as tp
    from flexflow_tpu_torch.serving.engine import InferenceEngine as TEngine
    from flexflow_tpu_torch.serving.request_manager import GenerationConfig as TGen
    from flexflow_tpu_torch.serving.request_manager import RequestManager as TRM
    from flexflow_tpu_torch.serving.spec_manager import SpecRequestManager as TSRM
    from flexflow_tpu_torch.serving.speculative import SpecEngine as TSpecEngine
    from flexflow_tpu_torch.utils.profiling import per_op_profile as t_per_op

    kw = dict(arch="LlamaForCausalLM", vocab_size=96, hidden_size=64, num_layers=2,
              num_heads=4, num_kv_heads=2, head_dim=16, intermediate_size=128,
              max_position_embeddings=256, norm_eps=1e-6)
    jparams = jp.init_params(jspecs.ModelSpec(**kw), jax.random.PRNGKey(0), jnp.float32)
    tparams = tp.params_from_numpy(jax.tree.map(np.asarray, jparams))
    js, ts = jspecs.ModelSpec(**kw), tspecs.ModelSpec(**kw)
    monkeypatch.setattr(j_config.config, "profiling", True)
    monkeypatch.setattr(t_config.config, "profiling", True)
    prompts, ekw = [[3, 17, 91, 5], [8, 13, 21]], dict(max_requests_per_batch=2, max_seq_len=64)

    outs = []
    for pipelined in (True, False):
        for jax_side in (True, False):
            if jax_side:
                rm = JRM(JEngine(js, jparams, cache_dtype=jnp.float32, **ekw), decode_horizon=4,
                         pipelined=pipelined)
                toks = [r.output_tokens for r in rm.generate(prompts, JGen(max_new_tokens=6))]
            else:
                rm = TRM(TEngine(ts, tparams, cache_dtype=torch.float32, device="cpu", **ekw),
                         decode_horizon=4, pipelined=pipelined)
                toks = [r.output_tokens for r in rm.generate(prompts, TGen(max_new_tokens=6))]
                rm.close()
            outs.append((toks, capsys.readouterr().out))
        (jt, jout), (tt, tout) = outs[-2:]
        assert tt == jt
        assert _phase_names(tout) == _phase_names(jout)
        assert _op_rows(tout) == _op_rows(jout) and len(_op_rows(tout)) == 7
    assert _phase_names(outs[0][1]) == ["admit", "decode_dispatch", "horizon_fetch"]

    skw = dict(beam_width=2, beam_depth=2, max_requests_per_batch=2, max_seq_len=64)
    JSRM(JSpecEngine(js, jparams, js, jparams, cache_dtype=jnp.float32, **skw)).generate(
        prompts, JGen(max_new_tokens=6))
    jout = capsys.readouterr().out
    TSRM(TSpecEngine(ts, tparams, ts, tparams, cache_dtype=torch.float32, device="cpu",
                     **skw)).generate(prompts, TGen(max_new_tokens=6))
    tout = capsys.readouterr().out
    assert _phase_names(tout) == _phase_names(jout) == ["admit", "draft", "verify"]

    jrows = j_per_op(js, jparams, batch=2, seq=8, cache_len=32, reps=1)
    trows = t_per_op(ts, tparams, batch=2, seq=8, cache_len=32, reps=1)
    assert _op_rows("\n".join(trows)) == _op_rows("\n".join(jrows))
    assert all("forward time" in r for r in trows)


def test_capture_trace_writes_a_chrome_trace(tmp_path):
    from flexflow_tpu_torch.utils.profiling import capture_trace

    with capture_trace(str(tmp_path / "trace")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


def test_chat_cli_matches_jax(model_dir, monkeypatch, capsys):
    from flexflow_tpu_torch.inference import chat as t_chat
    from inference import chat as j_chat

    argv = ["-llm-model", model_dir, "--full-precision", "--max-sequence-length", "128",
            "--max-new-tokens", "6"]
    outs = []
    for main, extra in ((j_chat.main, []), (t_chat.main, ["--device", "cpu"])):
        lines = iter(["hello", "more please", "exit"])
        monkeypatch.setattr(builtins, "input", lambda _prompt="": next(lines))
        assert main(argv + extra) == 0
        outs.append([ln for ln in capsys.readouterr().out.splitlines()
                     if ln.startswith("assistant>")])
    assert outs[1] == outs[0] and len(outs[1]) == 2


@pytest.mark.parametrize("module,call,package", [
    ("entrypoint.fastapi_incr", "create_app", "fastapi"),
    ("entrypoint.fastapi_specinfer", "create_app", "fastapi"),
    ("usecases.gradio_chat", "main", "gradio"),
    ("usecases.gradio_incr", "main", "gradio"),
    ("usecases.gradio_specinfer", "main", "gradio"),
    ("streamlit.app", "main", "streamlit"),
])
def test_optional_mirrors_import_without_their_package(module, call, package):
    import importlib
    import importlib.util

    if importlib.util.find_spec(package) is not None:
        pytest.skip(f"{package} is installed")
    mod = importlib.import_module(f"flexflow_tpu_torch.inference.{module}")
    assert package not in sys.modules
    with pytest.raises(ImportError, match=package):
        getattr(mod, call)()
