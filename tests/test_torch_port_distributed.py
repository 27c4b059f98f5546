"""Multi-process serving of the port (``parallel/distributed.py`` and the
background server under a mesh) on the CPU, held against the JAX package at
float32:

(a) JAX's own case (``tests/test_distributed.py``'s spec, prompts and 12
    new tokens): two real processes formed through ``init_distributed`` and
    the ``FF_*`` variables serve through ``serve_distributed`` at
    ``make_mesh(model=2)`` and then ``make_mesh(data=2)``; both ranks give
    the same tokens, and they are the JAX package's one-device greedy
    tokens on the same parameters;
(b) ``LLM.start_server`` under a mesh at T = 2 (pipelined horizon), T = 2
    with a draft, P = 2 and C = 2: rank 0 registers from two threads,
    staggered, one streaming; every request has the same guid and tokens
    on both ranks, and JAX's one-device greedy tokens; a stop and a restart
    on every rank go on in step; rank 1's ``generate`` raises meanwhile;
(c) ``openai_server.serve`` under a mesh at T = 2: rank 0 answers as JAX's
    endpoint does, rank 1 binds nothing and returns when rank 0 stops;
(d) the broadcaster alone (JAX's frame, a payload over 1 MiB, a controller
    that closes without the sentinel) and the loop in one process over a
    stand-in broadcaster (one tick a step, none while idle, a follower's
    refusal, a dying controller); a follower's OpenAI or HTTP ``serve``
    binds no port.

The ranks import no JAX: the parent computes JAX's tokens while they run.
Each multi-process test has its own time limit, which kills its ranks.
"""

import os
import pickle
import queue
import signal
import socket
import struct
import sys
import threading
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from test_torch_port_mesh_serving import _jax_params, unfused_jax  # noqa: F401 (a fixture)

LIMIT_S = 120
MAX_SEQ = 128
# tests/test_distributed.py's model, prompts and budget
JAX_SPEC = dict(arch="LlamaForCausalLM", vocab_size=128, hidden_size=32, num_layers=2,
                num_heads=4, num_kv_heads=4, head_dim=8, intermediate_size=64,
                max_position_embeddings=128, norm_eps=1e-6)
JAX_ENGINE = dict(max_requests_per_batch=4, max_seq_len=64)
JAX_NEW = 12
# (b): the LLM's configurations under a mesh, and the served traffic
CONFIGS = {
    "t2": dict(tensor_parallelism_degree=2),
    "t2-draft": dict(tensor_parallelism_degree=2, draft=True, beam_width=2, beam_depth=3),
    "p2": dict(pipeline_parallelism_degree=2),
    "c2": dict(context_parallel_degree=2),
}
PROMPTS = ["hello world", "abc def", "the cat sat", "xyz"]
NEW = 24


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax_prompts():
    rng = np.random.RandomState(0)
    return [rng.randint(1, 128, size=6).tolist() for _ in range(3)]


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """A tiny HF LLaMA directory with a character-level tokenizer (as
    ``test_torch_port_server.py``'s)."""
    import json

    import transformers
    from tokenizers import Tokenizer
    from tokenizers import models as tok_models

    d = tmp_path_factory.mktemp("tiny_llama_distributed")
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


# ---------------------------------------------------------------------------
# the ranks (no JAX)
# ---------------------------------------------------------------------------


def _rank_main(rank, world, coordinator, runner, arg, out_path):
    """One rank, formed as a user forms it: the ``FF_*`` variables and
    ``init_distributed``; then ``runner(arg)``'s results to ``out_path``."""
    import torch.distributed as dist

    from flexflow_tpu_torch.parallel.distributed import init_distributed

    torch.set_num_threads(1)
    os.environ.update(FF_COORDINATOR_ADDRESS=coordinator, FF_NUM_PROCESSES=str(world),
                      FF_PROCESS_ID=str(rank))
    init_distributed(device="cpu")
    try:
        res = runner(arg)
        res["jax imported"] = "jax" in sys.modules  # the port and the ranks import none
        with open(f"{out_path}.{rank}", "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


def _jax_case(arg):
    """(a): ``serve_distributed`` at model=2, then data=2, over one
    broadcaster."""
    from flexflow_tpu_torch.models import params as tp
    from flexflow_tpu_torch.parallel.distributed import (RequestBroadcaster, is_controller,
                                                         serve_distributed)
    from flexflow_tpu_torch.parallel.mesh import make_mesh
    from flexflow_tpu_torch.serving.engine import InferenceEngine
    from flexflow_tpu_torch.serving.request_manager import GenerationConfig, RequestManager
    from flexflow_tpu_torch.specs import ModelSpec

    spec = ModelSpec(**JAX_SPEC)
    bc = RequestBroadcaster(port=arg["bport"])
    out = {}
    for name, degrees in (("model", dict(model=2)), ("data", dict(data=2))):
        mesh = make_mesh(**degrees, device="cpu")
        engine = InferenceEngine(spec, tp.params_from_numpy(arg["params"], spec=spec, mesh=mesh),
                                 cache_dtype=torch.float32, device="cpu", mesh=mesh, **JAX_ENGINE)
        rm = RequestManager(engine, seed=0)
        ctrl = is_controller()
        reqs = serve_distributed(rm, bc, arg["prompts"] if ctrl else None,
                                 GenerationConfig(max_new_tokens=JAX_NEW) if ctrl else None)
        out[name] = [r.output_tokens for r in reqs]
        rm.close()
    out["ticks"] = bc.stats["messages"]
    bc.close()
    return out


def _records(rm):
    return {g: (r.prompt_tokens, r.output_tokens, r.state) for g, r in rm._requests.items()}


def _lead_traffic(llm):
    """Rank 0 under (b): a stream, and two requests from a second thread
    once its first delta has arrived; a stop; a restart serving one more."""
    llm.start_server()
    stream = llm.generate_stream(PROMPTS[0], max_new_tokens=NEW)
    deltas = [next(stream)]
    wave = {}
    second = threading.Thread(target=lambda: wave.update(
        res=llm.generate(PROMPTS[1:3], max_new_tokens=NEW)))
    second.start()
    deltas += list(stream)
    second.join()
    llm.stop_server()
    llm.start_server()
    [again] = llm.generate(PROMPTS[3], max_new_tokens=NEW)
    llm.stop_server()
    ids = llm._token_ids(PROMPTS[0])
    [g0] = [g for g, r in llm.rm._requests.items() if r.prompt_tokens == ids]
    guids = [g0] + [r.guid for r in wave["res"]] + [again.guid]
    text0 = llm.tokenizer.decode(llm.rm._requests[g0].output_tokens, skip_special_tokens=True)
    return dict(guids=guids, stream="".join(deltas), text0=text0, requests=_records(llm.rm),
                steps=llm.rm.total_decoding_steps, ticks=llm.rm.broadcaster.stats["messages"])


def _follow_traffic(llm):
    """Another rank under (b): its ``generate`` is refused while the server
    runs; it stops and restarts with rank 0."""
    llm.start_server()
    try:
        llm.generate(PROMPTS[0], max_new_tokens=NEW)
        refused = None
    except RuntimeError as e:
        refused = str(e)
    llm.stop_server()  # returns on rank 0's sentinel
    llm.start_server()
    llm.stop_server()
    return dict(refused=refused, requests=_records(llm.rm), steps=llm.rm.total_decoding_steps)


def _server_case(arg):
    """(b): every configuration of ``CONFIGS`` behind ``start_server``."""
    from flexflow_tpu_torch.parallel.distributed import is_controller
    from flexflow_tpu_torch.serve import LLM, SSM

    out = {}
    for name, port in zip(CONFIGS, arg["ports"]):
        kw = dict(CONFIGS[name])
        drafts = ([SSM(arg["model_dir"], data_type="float32", device="cpu")]
                  if kw.pop("draft", False) else [])
        llm = LLM(arg["model_dir"], data_type="float32", device="cpu")
        llm.compile(max_requests_per_batch=2, max_seq_length=MAX_SEQ, ssms=drafts,
                    broadcast_port=port, **kw)
        out[name] = (_lead_traffic if is_controller() else _follow_traffic)(llm)
        llm.rm.broadcaster.close()
    return out


def _openai_case(arg):
    """(c): ``openai_server.serve`` at T = 2 on every rank; rank 0 runs
    until interrupted."""
    from flexflow_tpu_torch.inference.entrypoint import openai_server
    from flexflow_tpu_torch.serve import LLM

    bound = []

    class Recording(openai_server.ThreadingHTTPServer):
        def __init__(self, address, handler):
            bound.append(address)
            super().__init__(address, handler)

    openai_server.ThreadingHTTPServer = Recording
    llm = LLM(arg["model_dir"], data_type="float32", device="cpu")
    llm.compile(max_requests_per_batch=2, max_seq_length=MAX_SEQ, tensor_parallelism_degree=2,
                broadcast_port=arg["bport"])
    try:
        openai_server.serve(llm, host="127.0.0.1", port=arg["http"], model_name="tiny-llama")
        ended = "returned"
    except KeyboardInterrupt:
        ended = "interrupted"
    return dict(bound=bound, ended=ended, stopped=llm.rm._server_thread is None,
                requests=_records(llm.rm))


# ---------------------------------------------------------------------------
# the parent
# ---------------------------------------------------------------------------


def _start(tmp_path, runner, arg, world=2):
    ctx = mp.start_processes(
        _rank_main, args=(world, f"127.0.0.1:{_free_port()}", runner, arg,
                          str(tmp_path / "out")),
        nprocs=world, join=False, start_method="spawn")
    return ctx, time.monotonic() + LIMIT_S


def _join(tmp_path, started, world=2):
    """Every rank's results; the ranks are killed at the time limit."""
    ctx, deadline = started
    try:
        while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                pytest.fail(f"{world} ranks did not finish within {LIMIT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    out = []
    for r in range(world):
        with open(tmp_path / f"out.{r}", "rb") as f:
            out.append(pickle.load(f))
    assert not any(r.pop("jax imported") for r in out)
    return out


def _jax_llm(model_dir):
    from flexflow_tpu.serve import LLM as JLLM

    llm = JLLM(model_dir, data_type="float32")
    llm.compile(max_requests_per_batch=2, max_seq_length=MAX_SEQ)
    return llm


def test_jax_case_serve_distributed_over_model_then_data(tmp_path, unfused_jax):
    """(a) JAX's two-process case through the port: both ranks' tokens equal
    and equal to JAX's one-device greedy tokens, at model=2 and data=2."""
    import jax.numpy as jnp

    from flexflow_tpu.serving import GenerationConfig, InferenceEngine, RequestManager

    prompts = _jax_prompts()
    js, jparams, npp = _jax_params(JAX_SPEC, 0)
    started = _start(tmp_path, _jax_case, dict(params=npp, prompts=prompts,
                                               bport=_free_port()))
    engine = InferenceEngine(js, jparams, cache_dtype=jnp.float32, **JAX_ENGINE)
    want = [r.output_tokens for r in RequestManager(engine, seed=0).generate(
        prompts, GenerationConfig(max_new_tokens=JAX_NEW))]
    r0, r1 = _join(tmp_path, started)
    assert len(want) == 3 and all(len(t) == JAX_NEW for t in want)
    for name in ("model", "data"):
        assert r0[name] == r1[name], name
        assert r0[name] == want, name
    assert r0["ticks"] == 2  # one broadcast a serve_distributed


@pytest.fixture(scope="module")
def served(model_dir, tmp_path_factory):
    """(b)'s ranks' results beside JAX's one-device tokens and texts."""
    tmp = tmp_path_factory.mktemp("served")
    started = _start(tmp, _server_case, dict(model_dir=model_dir,
                                             ports=[_free_port() for _ in CONFIGS]))
    want = _jax_llm(model_dir).generate(PROMPTS, max_new_tokens=NEW)
    return _join(tmp, started), want


@pytest.mark.parametrize("config", list(CONFIGS))
def test_start_server_under_a_mesh_matches_jax(served, config):
    """(b) every request's guid and tokens equal on both ranks and JAX's
    one-device greedy tokens; the stream's deltas join to its text; the
    follower refused its own request; a restart served in step."""
    (r0, r1), want = served
    lead, follow = r0[config], r1[config]
    assert lead["requests"] == follow["requests"]
    assert lead["steps"] == follow["steps"]
    assert len(lead["guids"]) == len(PROMPTS) == len(set(lead["guids"]))
    for i, g in enumerate(lead["guids"]):
        _, tokens, state = lead["requests"][g]
        assert state == "COMPLETED"
        assert tokens == want[i].output_tokens and len(tokens) == NEW, (i, g)
    assert lead["stream"] == lead["text0"] == want[0].output_text
    assert "rank 0" in follow["refused"]
    assert lead["ticks"] > 2  # the two stops' sentinels and at least one tick


def test_openai_server_under_a_mesh_answers_on_rank_0_only(model_dir, tmp_path):
    """(c) rank 0 answers a completion and a streamed one with JAX's
    endpoint's body; rank 1 binds nothing and returns when rank 0 stops."""
    from test_torch_port_server import OPENAI_CASES, _comparable, _http, _request

    from inference.entrypoint import openai_server as j_openai

    http = _free_port()
    started = _start(tmp_path, _openai_case, dict(model_dir=model_dir, http=http,
                                                  bport=_free_port()))
    jllm = _jax_llm(model_dir)
    jllm.start_server()
    jsrv = _http(jllm, j_openai.make_handler(jllm, "tiny-llama"))
    ctx, deadline = started
    try:
        while True:  # rank 0's endpoint comes up once both ranks have compiled
            try:
                if _request(http, "/health")[0] == 200:
                    break
            except OSError:
                pass
            assert time.monotonic() < deadline and all(p.is_alive() for p in ctx.processes)
            time.sleep(0.2)
        for case in ("completion", "stream"):
            path, body = OPENAI_CASES[case]
            want = _comparable(*_request(jsrv.server_address[1], path, body))
            got = _comparable(*_request(http, path, body))
            assert got == want and got[0] == 200, case
    finally:
        jsrv.shutdown()
        jsrv.server_close()
        jllm.stop_server()
        if ctx.processes[0].is_alive():
            os.kill(ctx.processes[0].pid, signal.SIGINT)
    r0, r1 = _join(tmp_path, started)
    assert r0["bound"] == [("127.0.0.1", http)] and r0["ended"] == "interrupted"
    assert r1["bound"] == [] and r1["ended"] == "returned"
    assert r0["stopped"] and r1["stopped"]
    assert r0["requests"] == r1["requests"] and len(r0["requests"]) == 2


# ---------------------------------------------------------------------------
# (d) the broadcaster alone, and the loop over a stand-in broadcaster
# ---------------------------------------------------------------------------

BIG = {"prompts": [list(range(300000))], "note": "over 1 MiB pickled"}


def _recv_exact(sock, n):
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        assert chunk
        buf += chunk
    return buf


def test_controller_frames_are_jax_wire_format(monkeypatch):
    """The controller sends each message as 8 bytes of ``<Q`` length and the
    pickle, to every follower that connected."""
    from flexflow_tpu_torch.parallel import distributed

    monkeypatch.setattr(distributed, "process_count", lambda: 2)
    port = _free_port()
    made = {}
    t = threading.Thread(target=lambda: made.update(bc=distributed.RequestBroadcaster(port)))
    t.start()
    for _ in range(300):  # the controller binds on its thread
        try:
            follower = socket.create_connection(("127.0.0.1", port), timeout=30)
            break
        except ConnectionRefusedError:
            time.sleep(0.01)
    t.join(30)
    bc = made["bc"]
    try:
        blob = pickle.dumps(BIG)
        assert len(blob) > 1 << 20
        assert bc.broadcast(BIG) is BIG
        bc.broadcast(None)
        assert _recv_exact(follower, 8) == struct.pack("<Q", len(blob))
        assert _recv_exact(follower, len(blob)) == blob
        assert _recv_exact(follower, 8 + len(pickle.dumps(None))) == (
            struct.pack("<Q", len(pickle.dumps(None))) + pickle.dumps(None))
        assert bc.stats["messages"] == 2
        assert bc.stats["bytes"] == 16 + len(blob) + len(pickle.dumps(None))
        with pytest.raises(RuntimeError, match="does not receive"):
            bc.recv()
    finally:
        bc.close()
        follower.close()
    with pytest.raises(ConnectionError, match="closed"):
        bc.broadcast([])


@pytest.mark.parametrize("cut", ["between", "mid-message"])
def test_follower_recv_and_a_controller_that_closes(monkeypatch, cut):
    """A follower reads a payload over 1 MiB sent in pieces, and the
    sentinel; a controller that closes without the sentinel (between two
    messages, or inside one) makes its ``recv`` raise ``ConnectionError``."""
    from flexflow_tpu_torch.parallel import distributed

    monkeypatch.setattr(distributed, "is_controller", lambda: False)
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    bc = distributed.RequestBroadcaster(srv.getsockname()[1], host="127.0.0.1")
    ctrl, _ = srv.accept()
    srv.close()
    try:
        blob = pickle.dumps(BIG)
        frame = struct.pack("<Q", len(blob)) + blob
        sender = threading.Thread(target=lambda: [ctrl.sendall(frame[i:i + 70001])
                                                  for i in range(0, len(frame), 70001)])
        sender.start()
        assert bc.recv() == BIG
        sender.join()
        none = pickle.dumps(None)
        ctrl.sendall(struct.pack("<Q", len(none)) + none)
        assert bc.recv() is None
        if cut == "mid-message":
            ctrl.sendall(frame[:1000])
        ctrl.close()
        with pytest.raises(ConnectionError,
                           match="mid-message" if cut == "mid-message" else "controller closed"):
            bc.recv()
        with pytest.raises(RuntimeError, match="only the controller"):
            bc.broadcast([])
    finally:
        bc.close()


_CLOSED = object()


class _Pipe:
    """A stand-in broadcaster in one process: the controller puts each
    message into every follower's queue; closing it ends their reads."""

    def __init__(self, queues, controller):
        self.queues, self.controller, self.closed, self.sent = queues, controller, False, []

    def broadcast(self, obj):
        if self.closed:
            raise ConnectionError("the broadcaster is closed")
        self.sent.append(obj)
        for q in self.queues:
            q.put(obj)
        return obj

    def recv(self):
        obj = self.queues[0].get(timeout=LIMIT_S)
        if obj is _CLOSED:
            raise ConnectionError("controller closed")
        return obj

    def close(self):
        if self.controller and not self.closed:
            for q in self.queues:
                q.put(_CLOSED)
        self.closed = True


def _managers(n_followers=1, broadcast=True):
    """A controller's and followers' RequestManagers (pipelined, horizon 4)
    on one tiny model, each with its own engine, joined by ``_Pipe``s."""
    from flexflow_tpu_torch.models import params as tp
    from flexflow_tpu_torch.serving.engine import InferenceEngine
    from flexflow_tpu_torch.serving.request_manager import RequestManager
    from flexflow_tpu_torch.specs import ModelSpec

    spec = ModelSpec(**JAX_SPEC)
    params = tp.init_params(spec, 0)
    queues = [queue.Queue() for _ in range(n_followers)]
    pipes = [_Pipe(queues, True)] + [_Pipe([q], False) for q in queues]
    return [RequestManager(InferenceEngine(spec, params, cache_dtype=torch.float32,
                                           device="cpu", **JAX_ENGINE),
                           decode_horizon=4, pipelined=True,
                           broadcaster=pipe if broadcast else None)
            for pipe in pipes]


def _count_steps(rm):
    calls, step = [0], rm.step

    def counted():
        calls[0] += 1
        return step()

    rm.step = counted
    return calls


def test_loop_sends_one_tick_a_step_and_none_while_idle():
    """Over a stand-in broadcaster: the follower steps once per tick and
    ends with the controller's guids and tokens (a one-device run's); the
    controller sends one tick per step, none while idle, and the sentinel
    when stopped; the follower refuses its own registrations while it
    serves; a stop and a restart go on in step."""
    from flexflow_tpu_torch.serving.request_manager import GenerationConfig

    lead, follow = _managers()
    [plain] = _managers(0, broadcast=False)
    steps = [_count_steps(lead), _count_steps(follow)]
    cfg = GenerationConfig(max_new_tokens=9)
    prompts = [[1, 2, 3], [4, 5], [7, 8, 9, 10], [11]]
    want = [r.output_tokens for r in plain.generate(prompts, cfg)]
    follow.start_background_server()
    lead.start_background_server()
    with pytest.raises(RuntimeError, match="rank 0"):
        follow.register_request([1, 2, 3], cfg)
    wave = {}
    second = threading.Thread(target=lambda: wave.update(r=lead.generate(prompts[:2], cfg)))
    second.start()
    third = lead.generate(prompts[2:3], cfg)
    second.join()
    time.sleep(0.1)  # the loop drains and goes idle
    sent = len(lead.broadcaster.sent)
    time.sleep(0.1)
    assert len(lead.broadcaster.sent) == sent  # idle: nothing sent
    lead.stop_server()
    follow.stop_server()
    lead.start_background_server()
    follow.start_background_server()
    [last] = lead.generate(prompts[3:], cfg)
    lead.stop_server()
    follow.stop_server()
    ticks = lead.broadcaster.sent
    assert [i for i, t in enumerate(ticks) if t is None] == [sent, len(ticks) - 1]
    assert len(ticks) - 2 == steps[0][0] == steps[1][0] > 0
    assert [g for t in ticks if t for g, _, _ in t] == sorted(lead._requests)
    assert _records(lead) == _records(follow)
    got = [r.output_tokens for r in wave["r"] + third + [last]]
    assert got == want
    for rm in (lead, follow, plain):
        rm.close()


def test_a_dying_controller_loop_ends_its_followers():
    """The controller's loop dies in a step: its waiter gets the error, its
    broadcaster closes, the followers' loops end with ``ConnectionError``
    and the controller refuses to restart out of step."""
    from flexflow_tpu_torch.serving.request_manager import GenerationConfig

    lead, *follows = _managers(2)
    step, calls = lead.step, [0]

    def dies_at_third():
        calls[0] += 1
        if calls[0] == 3:
            raise RuntimeError("boom")
        return step()

    lead.step = dies_at_third
    for rm in (*follows, lead):
        rm.start_background_server()
    with pytest.raises(RuntimeError, match="boom"):
        lead.generate([[1, 2, 3]], GenerationConfig(max_new_tokens=20))
    for rm in follows:
        rm._server_thread.join(LIMIT_S)
        assert not rm._server_thread.is_alive()
        with pytest.raises(RuntimeError, match="ConnectionError"):
            rm.register_request([1], GenerationConfig())
    assert lead.broadcaster.closed
    lead.stop_server()
    with pytest.raises(RuntimeError, match="broadcaster is closed"):
        lead.start_background_server()
    for rm in (*follows, lead):
        rm.close()


@pytest.mark.parametrize("module", ["openai_server", "http_server"])
def test_a_follower_binds_no_endpoint(monkeypatch, module):
    """Under a mesh a rank other than 0 starts the serving loop, binds no
    port and returns once its loop has ended (rank 0's sentinel)."""
    import importlib

    mod = importlib.import_module(f"flexflow_tpu_torch.inference.entrypoint.{module}")
    calls = []

    class Follower:
        mesh = object()

        def start_server(self):
            calls.append("start")

        def stop_server(self):
            calls.append("stop")

    def refuse(*a, **kw):
        raise AssertionError("a follower bound a port")

    monkeypatch.setattr(mod, "is_controller", lambda: False)
    monkeypatch.setattr(mod, "ThreadingHTTPServer", refuse)
    assert mod.serve(Follower(), port=_free_port()) is None
    assert calls == ["start", "stop"]
