"""User-facing serving API: ``LLM`` and ``SSM`` (port of
``flexflow_tpu/serve.py``: incremental decoding, and tree-speculative
decoding with one or several draft models, on one device).

``LLM(model_dir).compile(...)`` loads a local HuggingFace model directory and
builds the engine and scheduler; with ``ssms=[SSM(draft_dir)]`` it builds a
``SpecEngine`` and a fused, pipelined ``SpecRequestManager`` instead, and
with several drafts one ``SpecEngine`` a draft over one verifier and a
``MultiSSMSpecManager`` that rotates them or, with ``merge_ssm_trees``,
verifies their merged trees in one pass.
``compile(offload=True)`` (``--offload``) serves the incremental engine
with its layer stack in pinned host memory, streamed in per layer.
``generate(prompts)`` tokenizes, serves and detokenizes. LoRA adapters
registered before ``compile`` (``register_peft_adapter``) are stacked into
slots and routed per request (``generate(..., adapter_id=)``).
``start_server()`` runs the scheduler on a background thread: ``generate``
then only registers and waits, so concurrent callers share the batch, and
``generate_stream`` yields text deltas as horizons are fetched. The
tokenizer is imported lazily (``transformers``). Runs on ``cuda`` unless
``device`` names another device.

``compile(tensor_parallelism_degree=T, data_parallelism_degree=D)`` serves
on ``T * D`` ranks (one process each, e.g. under ``torchrun``): every rank
calls the same methods with the same prompts, loads only its own cut of
the weights (``parallel/sharding``) and gets the same results
(``parallel/mesh``). Registered LoRA adapters are cut with the model and
a co-scheduled finetuning session steps on every rank alike;
``save_peft_adapter`` gathers the slot and writes it from rank 0; with
``offload`` each rank pins and streams its own cut of the layers.
``compile(pipeline_parallelism_degree=P)`` serves over ``P * T`` ranks:
each rank loads only its pipeline stage's layers (and its cut of them
under ``T``) and serves through ``serving/pp_engine.PipelineInferenceEngine``
(JAX's refusals kept: data > 1, LoRA with T > 1, offload, PEFT with drafts,
merged trees); with draft models, through ``serving/pp_spec.PipelineSpecEngine``
(the verifier staged, each draft whole on every rank; several drafts rotate
over one staged verifier). ``compile(context_parallel_degree=C)`` (alone
or with the tensor and data degrees, with or without drafts) cuts the
verifier's KV cache on its positions over C seq ranks and merges the
attention over them (``serving/engine.py``, ``serving/speculative.py``;
the draft whole on every rank; several drafts rotate or merge over it),
with offload and LoRA adapters (a co-scheduled finetuning session steps on
every seq rank alike). With pipeline stages (``P x T x C`` ranks) each seq
coordinate serves its own copy of the stages, each stage's cache whole, as
JAX's pipeline engines replicate over ``seq``.
Under a mesh ``start_server()`` and ``stop_server()`` are called on every
rank: rank 0 (the controller) takes the requests (``generate``,
``generate_stream``) and its loop broadcasts each step's new ones to the
other ranks' loops (``parallel/distributed.RequestBroadcaster``, made at the
first ``start_server`` on ``compile(broadcast_port=)``, JAX's 47551 by
default); on the other ranks ``generate`` raises while the server runs.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

import torch

from flexflow_tpu_torch.config import config as _ffconfig
from flexflow_tpu_torch.device import resolve_device
from flexflow_tpu_torch.parallel import auto as auto_lib
from flexflow_tpu_torch.parallel.distributed import DEFAULT_PORT, RequestBroadcaster
from flexflow_tpu_torch.parallel.mesh import make_mesh
from flexflow_tpu_torch.peft.lora import (LoraConfig, export_hf_adapter, init_lora_params,
                                         load_hf_adapter_config, load_hf_adapter_into_slot,
                                         unroute_lora)
from flexflow_tpu_torch.serving.engine import InferenceEngine
from flexflow_tpu_torch.serving.pp_engine import PipelineInferenceEngine
from flexflow_tpu_torch.serving.pp_spec import PipelineSpecEngine
from flexflow_tpu_torch.serving.request_manager import FAILED, GenerationConfig, RequestManager
from flexflow_tpu_torch.serving.spec_manager import (NO_ADAPTERS, MultiSSMSpecManager,
                                                     SpecRequestManager)
from flexflow_tpu_torch.serving.speculative import SpecEngine, tree_size
from flexflow_tpu_torch.utils import hf_weights

_DTYPES = {
    "float32": torch.float32,
    "fp32": torch.float32,
    "float16": torch.bfloat16,
    "half": torch.bfloat16,
    "bfloat16": torch.bfloat16,
    "bf16": torch.bfloat16,
}


@dataclasses.dataclass
class GenerationResult:
    guid: int
    prompt: str
    output_text: str
    output_tokens: List[int]
    decoding_steps: int
    ttft_ms: float
    latency_ms: float


class LLM:
    """A served causal LM."""

    mesh = None  # this rank's parallel/mesh.Mesh once compile has made one
    auto_report = None  # the serving layout search's, when compile ran it
    broadcast_port = DEFAULT_PORT  # the request broadcaster's, under a mesh

    def __init__(self, model_dir: str, *, data_type: str = "bfloat16",
                 quantization: Optional[str] = None, output_file: str = "",
                 device=None):
        self.device = resolve_device(device)
        self.model_dir = model_dir
        self.dtype = _DTYPES[data_type]
        self.quant_bits = {"int8": 8, "int4": 4, None: None}[quantization]
        self.output_file = output_file
        self.spec = hf_weights.load_spec(model_dir)
        self.params = None
        self.tokenizer = None
        self.rm: Optional[Union[RequestManager, SpecRequestManager]] = None
        self._ssms: List["SSM"] = []
        self._peft: List[Tuple[LoraConfig, Optional[str]]] = []  # (config, adapter dir or None)
        self.lora = None
        self.lora_config: Optional[LoraConfig] = None

    def register_ssm(self, ssm: "SSM") -> None:
        """Register a draft model for speculative decoding."""
        self._ssms.append(ssm)

    def register_peft_adapter(self, adapter: Union[str, LoraConfig]) -> int:
        """Register a LoRA adapter before ``compile``; returns its slot id.

        ``adapter`` is an HF PEFT adapter directory (``adapter_config.json``
        + ``adapter_model.safetensors``) or a :class:`LoraConfig` for a
        fresh adapter (B zero: the identity). All adapters share one rank
        and one set of target modules (one stacked slot layout)."""
        if isinstance(adapter, LoraConfig):
            cfg, path = adapter, None
        else:
            cfg, path = load_hf_adapter_config(adapter), adapter
        if self._peft:
            first = self._peft[0][0]
            if (cfg.rank, set(cfg.keys())) != (first.rank, set(first.keys())):
                raise ValueError("all adapters must share rank and target_modules (one stacked "
                                 f"slot layout): {cfg.rank}, {cfg.keys()} against "
                                 f"{first.rank}, {first.keys()}")
        self._peft.append((cfg, path))
        return len(self._peft) - 1

    def _build_lora(self):
        """The registered adapters' stacks: fresh ones from a seeded
        generator, HF PEFT directories loaded into their slots."""
        self.lora_config = self._peft[0][0]
        gen = torch.Generator(device=self.device).manual_seed(0)
        lora = init_lora_params(self.spec, self.lora_config, len(self._peft), gen, self.dtype,
                                self.device)
        for slot, (cfg, path) in enumerate(self._peft):
            if path is not None:
                load_hf_adapter_into_slot(path, self.spec, lora, slot, cfg)
        return lora

    def save_peft_adapter(self, adapter_dir: str, slot: int) -> None:
        """Export adapter slot ``slot`` as an HF PEFT directory, as the
        engine holds it now: a slot trained by a co-scheduled
        ``FinetuneSession`` is read back from the engine's routed adapters
        (``self.lora`` keeps the stacks as they were at ``compile``). Under
        a mesh every rank calls it (the slot is gathered over the model
        ranks) and rank 0 writes it."""
        if self.rm is None or self.rm.engine.lora is None:
            raise RuntimeError("no adapters: register them and call compile() first")
        engine = self.rm.engine
        export_hf_adapter(adapter_dir, self.spec, unroute_lora(engine.lora), slot,
                          self.lora_config, shard=engine.shard)

    def _load_params(self, host_layers: bool = False, mesh=None):
        _, params = hf_weights.load_params(
            self.model_dir, self.spec, dtype=self.dtype, quantize_bits=self.quant_bits,
            quantize_group_size=_ffconfig.quantization_group_size, device=self.device,
            host_layers=host_layers, mesh=mesh)
        return params

    def _make_mesh(self, tp: int, dp: int, pp: int, cp: int):
        """The serving mesh of the degrees (None for one device): this
        rank's device is ``cuda:LOCAL_RANK`` unless the LLM names one."""
        if max(tp, dp, pp, cp) == 1:
            return None
        named = self.device.type != "cuda" or self.device.index is not None
        mesh = make_mesh(data=dp, pipe=pp, model=tp, seq=cp,
                         device=self.device if named else None)
        self.device = mesh.device
        return mesh

    def _auto_layout(self, batch: int, max_seq_len: int):
        """JAX's serving layout over the ranks (``flexflow_tpu/serve.py``
        ``LLM.compile``): analytically alone when the whole model in the
        serving dtype passes 0.35 of a device's memory (the probe would not
        fit), else ``optimize_serving_layout`` on a seeded probe model of
        the spec. Only the tensor and pipeline degrees are served, as in
        JAX: a hybrid winner ``Layout(n / m, 1, m, hybrid_ffn=True)`` is
        served at T = m, which JAX runs on its first m devices. At m = 1
        every rank serves the whole model (JAX's one device); for 1 < m < n
        the ranks past m would idle, which one program over every rank
        cannot do: it raises."""
        from flexflow_tpu_torch.models.params import init_params

        sp, n = self.spec, auto_lib.device_count(self.device)
        mlp_mults = 3 if sp.act == "silu_gate" else 2
        n_params = sp.num_layers * (
            sp.hidden_size * (sp.num_heads + 2 * sp.num_kv_heads) * sp.head_dim
            + sp.num_heads * sp.head_dim * sp.hidden_size
            + mlp_mults * sp.hidden_size * sp.intermediate_size
        ) + 2 * sp.vocab_size * sp.hidden_size
        bpp = 2 if self.dtype == torch.bfloat16 else 4
        machine = auto_lib.MachineModel()
        if n_params * bpp > 0.35 * machine.hbm_bytes:
            cands = [lo for lo in auto_lib.enumerate_layouts(n, sp, batch) if lo.data == 1]
            layout = min(cands, key=lambda lo: auto_lib.analytic_cost(lo, sp, batch, max_seq_len,
                                                                      machine))
            self.auto_report = [{
                "layout": str(layout),
                "analytic_s": auto_lib.analytic_cost(layout, sp, batch, max_seq_len, machine),
                "measured_s": None, "note": "analytic-only (unsharded probe exceeds HBM)"}]
            if auto_lib.speaks():
                print(f"[auto-parallel] serving layout {layout} (analytic-only: model too "
                      "large for probe)")
        else:
            dev = auto_lib.search_device(self.device, n)
            probe = init_params(sp, 0, self.dtype, dev)
            layout, self.auto_report = auto_lib.optimize_serving_layout(
                sp, probe, batch_size=batch, max_seq_len=max_seq_len, cache_dtype=self.dtype,
                n_devices=n, device=dev)
            del probe
        m = layout.model * layout.pipe
        if 1 < m < n:
            raise NotImplementedError(
                f"the serving search chose {layout} over {n} ranks: JAX serves its tensor degree "
                f"alone (T={layout.model}) on its first {m} devices and leaves the others idle, "
                "which one program over every rank cannot do")
        return layout

    def compile(self, *, max_requests_per_batch: int = 8, max_seq_length: int = 256,
                max_tokens_per_batch: Optional[int] = None,
                tensor_parallelism_degree: int = 1, data_parallelism_degree: int = 1,
                pipeline_parallelism_degree: int = 1, context_parallel_degree: int = 1,
                beam_width: int = 3,
                beam_depth: int = 4, ssms: Sequence["SSM"] = (),
                merge_ssm_trees: bool = False, offload: Optional[bool] = None,
                auto_parallel: Optional[bool] = None,
                broadcast_port: Optional[int] = None) -> None:
        """Load the weights and build the engine and the scheduler: the
        incremental ``RequestManager``; with one registered draft model
        (``ssms``) the speculative ``SpecRequestManager`` (fused, and
        pipelined over a horizon of ``spec_horizon`` iterations); with
        several, a ``MultiSSMSpecManager`` over one engine a draft sharing
        the verifier's weights and cache, rotating the drafts (fused) or,
        with ``merge_ssm_trees``, verifying their merged trees.

        ``offload`` (default ``config.cpu_offload``, ``--offload``) keeps
        the layer stack in pinned host memory and streams it in layer by
        layer (``models/layer_store.py``), for the incremental engine, LoRA
        adapters included. With draft models it raises: the JAX package
        drops the flag there without a word.

        ``auto_parallel`` (default ``config.auto_parallel``,
        ``-auto-parallelism``) is JAX's serving layout search, which runs
        only over more than one device (and not with drafts, adapters or
        quantization), with the degrees left at 1: on one device it does
        nothing, as in JAX; over the ranks of the default process group it
        picks the tensor and pipeline degrees (``_auto_layout``).

        ``tensor_parallelism_degree`` x ``data_parallelism_degree`` (JAX's
        signature) serve over that many ranks (``parallel/mesh.make_mesh``;
        every rank calls ``compile`` and ``generate`` alike). LoRA adapters
        are cut with the model; with ``offload`` every rank pins its own cut
        of the layers. ``pipeline_parallelism_degree`` P x the tensor degree
        serve through ``PipelineInferenceEngine``, each rank loading only its
        stage; with drafts, ``PipelineSpecEngine`` (each draft loaded whole on
        every rank). JAX's refusals are kept (data > 1, LoRA with T > 1, PEFT
        with drafts, offload, merged trees of several drafts).
        ``context_parallel_degree`` C serves over ``C`` x the tensor and
        data degrees: each rank holds its block of ``max_seq_length / C``
        positions of the verifier's cache, the prefill is replicated over
        the seq ranks and the attention merged over them; the draft models
        stay whole on every rank. Offload and LoRA adapters keep that cut;
        with pipeline stages every seq rank runs its coordinate's copy of
        the stages, each holding the stage's whole cache (JAX's placement).
        ``broadcast_port`` is the TCP port of the mesh's request
        broadcaster (``start_server``)."""
        if broadcast_port is not None:
            self.broadcast_port = broadcast_port
        for ssm in ssms:
            self.register_ssm(ssm)
        if offload is None:
            offload = _ffconfig.cpu_offload
        if auto_parallel is None:
            auto_parallel = getattr(_ffconfig, "auto_parallel", False)
        degrees = (tensor_parallelism_degree, data_parallelism_degree,
                   pipeline_parallelism_degree, context_parallel_degree)
        if (auto_parallel and max(degrees) == 1 and not self._ssms and not self._peft
                and self.quant_bits is None and auto_lib.device_count(self.device) > 1):
            layout = self._auto_layout(max_requests_per_batch, max_seq_length)
            tensor_parallelism_degree, pipeline_parallelism_degree = layout.model, layout.pipe
            degrees = (layout.model, 1, layout.pipe, 1)
        use_pp = pipeline_parallelism_degree > 1
        if use_pp:
            # JAX's refusals under pipeline stages (flexflow_tpu/serve.py:250-268)
            if data_parallelism_degree > 1:
                raise NotImplementedError("pipeline-parallel serving requires data axis == 1")
            if self._peft and tensor_parallelism_degree > 1:
                raise NotImplementedError("LoRA adapters under pipeline parallelism require "
                                          "tensor_parallelism_degree == 1")
            if self._peft and self._ssms:
                raise NotImplementedError("PEFT with speculative decoding under PP is not "
                                          "supported")
            if offload:
                raise NotImplementedError(
                    "--offload under pipeline_parallelism_degree>1 is not supported "
                    "(stage-resident weights already hold only 1/P of the stack per device)")
            if merge_ssm_trees and len(self._ssms) > 1:
                raise NotImplementedError("merge_ssm_trees with pipeline parallelism is not "
                                          "supported; use rotation (merge_ssm_trees=False)")
        self.mesh = self._make_mesh(*degrees)
        if self._ssms and offload:
            raise NotImplementedError("CPU offload (A7b) serves the incremental engine only; "
                                      "speculative decoding with offload is not supported")
        if self._ssms and self._peft:
            raise NotImplementedError(NO_ADAPTERS)
        if max_tokens_per_batch is None:
            max_tokens_per_batch = 128
        self.params = self._load_params(host_layers=offload, mesh=self.mesh)
        self._load_tokenizer()
        if self._ssms:
            engines = []
            for ssm in self._ssms:
                # the first engine fuses and places (or stages) the verifier;
                # the others take its tensors and its cache
                first = engines[0] if engines else None
                kw = dict(beam_width=beam_width, beam_depth=beam_depth,
                          max_requests_per_batch=max_requests_per_batch,
                          max_seq_len=max_seq_length, cache_dtype=self.dtype, device=self.device)
                if use_pp:  # the draft whole on every rank, as JAX loads it
                    engines.append(PipelineSpecEngine(
                        self.spec, None if first else self.params, ssm.spec,
                        ssm._load_params(), mesh=self.mesh,
                        shared_pp=first._pp if first else None, **kw))
                else:
                    engines.append(SpecEngine(
                        self.spec, first.llm_params if first else self.params, ssm.spec,
                        ssm._load_params(mesh=self.mesh),
                        llm_cache=first.llm_cache if first else None, mesh=self.mesh, **kw))
            self.params = engines[0].llm_params  # the engines' tree (fused): no second copy
            if len(engines) > 1:
                self.rm = MultiSSMSpecManager(engines, merged=merge_ssm_trees,
                                              fused=not merge_ssm_trees)
                return
            # never let the per-request speculation margin (horizon x
            # (tree + 1)) take more than about a quarter of the context
            tree = tree_size(beam_width, beam_depth)
            spec_horizon = max(1, min(_ffconfig.spec_horizon,
                                      max_seq_length // (4 * (tree + 1))))
            self.rm = SpecRequestManager(engines[0], fused=True, spec_horizon=spec_horizon,
                                         pipelined=spec_horizon > 1,
                                         pipeline_depth=_ffconfig.pipeline_depth)
            return
        if self._peft:
            self.lora = self._build_lora()
        budget = max_tokens_per_batch if max_tokens_per_batch < max_seq_length else 0
        if use_pp:
            engine = PipelineInferenceEngine(
                self.spec, self.params, mesh=self.mesh,
                max_requests_per_batch=max_requests_per_batch, max_seq_len=max_seq_length,
                max_tokens_per_batch=budget, cache_dtype=self.dtype, device=self.device,
                lora=self.lora, lora_config=self.lora_config)
            self.params = engine.params
            self.rm = RequestManager(engine, decode_horizon=_ffconfig.decode_horizon,
                                     pipelined=_ffconfig.decode_horizon > 1,
                                     pipeline_depth=_ffconfig.pipeline_depth)
            return
        engine = InferenceEngine(
            self.spec, self.params,
            max_requests_per_batch=max_requests_per_batch,
            max_seq_len=max_seq_length,
            max_tokens_per_batch=budget,
            cache_dtype=self.dtype,
            device=self.device,
            lora=self.lora,
            lora_config=self.lora_config,
            offload=offload,
            mesh=self.mesh,
        )
        # the engine's tree (fused; under offload its layers are the store's
        # pinned leaves): the loaded tree is not kept beside it
        self.params = engine.params
        self.rm = RequestManager(
            engine,
            decode_horizon=_ffconfig.decode_horizon,
            pipelined=_ffconfig.decode_horizon > 1,
            pipeline_depth=_ffconfig.pipeline_depth,
        )

    def _load_tokenizer(self):
        if self.tokenizer is None:
            from transformers import AutoTokenizer

            self.tokenizer = AutoTokenizer.from_pretrained(self.model_dir)

    def _token_ids(self, prompt: Union[str, Sequence[int]]) -> List[int]:
        if isinstance(prompt, str):
            return self.tokenizer(prompt, return_tensors=None)["input_ids"]
        return [int(t) for t in prompt]

    def generate(self, prompts: Union[str, Sequence[int], Sequence[Union[str, Sequence[int]]]],
                 *, max_new_tokens: int = 128, temperature: float = 0.0, top_p: float = 1.0,
                 top_k: int = 0, adapter_id: int = -1,
                 stop_token_ids: Sequence[int] = ()) -> List[GenerationResult]:
        """Tokenize, serve, detokenize; ``adapter_id`` routes the requests
        through a registered LoRA adapter (-1: the base model). A prompt is
        a string or a list of token ids (served as given; its result's
        ``prompt`` is their decoded text). With the background server
        running this only registers and waits."""
        if self.rm is None:
            raise RuntimeError("call compile() first")
        if isinstance(prompts, str) or (prompts and isinstance(prompts[0], int)):
            prompts = [prompts]
        cfg = GenerationConfig(max_new_tokens=max_new_tokens, temperature=temperature,
                               top_p=top_p, top_k=top_k, adapter_id=adapter_id,
                               stop_token_ids=tuple(stop_token_ids))
        token_lists = [self._token_ids(p) for p in prompts]
        reqs = self.rm.generate(token_lists, cfg)
        results = [
            GenerationResult(
                guid=req.guid,
                prompt=prompt if isinstance(prompt, str) else self.tokenizer.decode(prompt),
                output_text=self.tokenizer.decode(req.output_tokens, skip_special_tokens=True),
                output_tokens=list(req.output_tokens),
                decoding_steps=req.profile.llm_decoding_steps,
                ttft_ms=req.profile.ttft * 1e3, latency_ms=req.profile.latency * 1e3)
            for prompt, req in zip(prompts, reqs)
        ]
        if self.output_file:
            with open(self.output_file, "a") as f:
                for r in results:
                    f.write(f"[Profile] guid({r.guid}) llm_decoding_steps("
                            f"{r.decoding_steps}) latency({r.latency_ms:.3f}) "
                            f"ttft({r.ttft_ms:.3f})\n")
        return results

    def generate_stream(self, prompt: Union[str, Sequence[int]], *, max_new_tokens: int = 128,
                        temperature: float = 0.0, top_p: float = 1.0, top_k: int = 0,
                        adapter_id: int = -1, stop_token_ids: Sequence[int] = (),
                        poll_s: float = 0.05):
        """Register the request and return an iterator of text deltas that
        the background server decodes (needs ``start_server()``); the
        deltas join to the whole output text. ``prompt`` is a string or a
        list of token ids. Registration errors (an oversize prompt) raise
        here; tokens arrive one fetched horizon at a time, and the iterator
        raises ``RuntimeError`` when the serving loop died under the
        request."""
        if self.rm is None:
            raise RuntimeError("call compile() first")
        if self.rm._server_thread is None:
            raise RuntimeError("generate_stream requires start_server()")
        cfg = GenerationConfig(max_new_tokens=max_new_tokens, temperature=temperature,
                               top_p=top_p, top_k=top_k, adapter_id=adapter_id,
                               stop_token_ids=tuple(stop_token_ids))
        req = self.rm.get_request(self.rm.register_request(self._token_ids(prompt), cfg))
        return self._deltas(req, poll_s)

    def _deltas(self, req, poll_s: float):
        sent = ""
        while True:
            done = req.done.wait(timeout=poll_s) or req.done.is_set()
            text = self.tokenizer.decode(list(req.output_tokens), skip_special_tokens=True)
            if not done:
                # a multi-byte character split across byte-fallback tokens
                # decodes to U+FFFD until its last byte arrives: hold it back
                while text.endswith("\ufffd"):
                    text = text[:-1]
            if len(text) > len(sent) and text.startswith(sent):
                yield text[len(sent):]
                sent = text
            if done:
                break
        if req.state == FAILED:
            raise RuntimeError(f"serving loop failed during generation: {req.error}")

    def start_server(self) -> None:
        """Start the background serving loop (incremental or speculative).
        Under a mesh every rank calls it: the first call connects the
        ranks' request broadcaster (the controller waits for its
        followers), and rank 0's loop then feeds the others its requests."""
        if self.mesh is not None and self.rm.broadcaster is None:
            self.rm.broadcaster = RequestBroadcaster(port=self.broadcast_port)
        self.rm.start_background_server()

    def stop_server(self) -> None:
        """Stop the background loop. Under a mesh every rank calls it: rank
        0 stops after its current step and sends the sentinel; the other
        ranks return once it has arrived."""
        if self.rm is not None:
            self.rm.stop_server()


class SSM(LLM):
    """A small speculative (draft) model, registered with ``LLM.compile(ssms=...)``."""

    def __init__(self, model_dir: str, *, data_type: str = "bfloat16",
                 quantization: Optional[str] = None, device=None):
        super().__init__(model_dir, data_type=data_type, quantization=quantization,
                         device=device)
