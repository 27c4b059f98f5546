#!/usr/bin/env python
"""Incremental-decoding CLI of the port (flag-compatible with
``inference/incr_decoding.py``).

    python -m flexflow_tpu_torch.inference.incr_decoding -llm-model DIR \\
        -prompt prompts.json --max-new-tokens 16 --device cuda

``--offload`` keeps the layer stack in pinned host memory and streams it
in per layer (``LLM.compile(offload=True)``). Tensor, data and pipeline
parallelism serve over ``T * D`` or ``P * T`` ranks, one process each
(rank 0 prints):

    torchrun --nproc-per-node 2 -m flexflow_tpu_torch.inference.incr_decoding \
        -llm-model DIR -tensor-parallelism-degree 2 [--device cpu]
    torchrun --nproc-per-node 2 -m flexflow_tpu_torch.inference.incr_decoding \
        -llm-model DIR --pp 2 [--device cpu]

``--pp`` (``-pipeline-parallelism-degree``) serves through the pipeline
engine, each rank holding its stage's layers. ``--cp``
(``-context-parallel-degree``) cuts the KV cache on its positions over
that many ranks (``LLM.compile(context_parallel_degree=)``), alone or
with ``-tensor-parallelism-degree`` / ``-data-parallelism-degree``:

    torchrun --nproc-per-node 2 -m flexflow_tpu_torch.inference.incr_decoding \
        -llm-model DIR --cp 2 [--device cpu]

``--cp`` composes with ``--pp`` (``P * T * C`` ranks: each seq
coordinate its own copy of the stages, each stage's cache whole) and with
``--offload``:

    torchrun --nproc-per-node 4 -m flexflow_tpu_torch.inference.incr_decoding \
        -llm-model DIR --pp 2 --cp 2 [--device cpu]

``-auto-parallelism`` with the degrees omitted runs JAX's serving layout
search over the ranks (``LLM.compile(auto_parallel=True)``; on one device
it does nothing, as in JAX):

    torchrun --nproc-per-node 2 -m flexflow_tpu_torch.inference.incr_decoding \
        -llm-model DIR -auto-parallelism [--device cpu]

Legion resource flags (``-ll:*``) are ignored.
"""

import argparse
import json
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Incremental decoding server (PyTorch port)")
    p.add_argument("-llm-model", "--llm-model", dest="model", required=True,
                   help="local HF model directory")
    p.add_argument("-prompt", "--prompt", dest="prompt", default="",
                   help="json file with a list of prompt strings")
    p.add_argument("-output-file", "--output-file", dest="output_file", default="")
    p.add_argument("--max-requests-per-batch", type=int, default=8)
    p.add_argument("--max-tokens-per-batch", type=int, default=128)
    p.add_argument("--max-sequence-length", type=int, default=256)
    p.add_argument("--max-new-tokens", type=int, default=128)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--topp", "--top-p", dest="topp", type=float, default=1.0)
    p.add_argument("--topk", "--top-k", dest="topk", type=int, default=0)
    p.add_argument("-tensor-parallelism-degree", "--tensor-parallelism-degree",
                   dest="tp", type=int, default=1)
    p.add_argument("-pipeline-parallelism-degree", "--pipeline-parallelism-degree", "--pp",
                   dest="pp", type=int, default=1)
    p.add_argument("-data-parallelism-degree", "--data-parallelism-degree",
                   dest="dp", type=int, default=1)
    p.add_argument("-context-parallel-degree", "--context-parallel-degree", "--cp",
                   dest="cp", type=int, default=1)
    p.add_argument("--fusion", action="store_true", help="accepted for parity")
    p.add_argument("-4bit-quantization", "--4bit-quantization", dest="int4",
                   action="store_true")
    p.add_argument("-8bit-quantization", "--8bit-quantization", dest="int8",
                   action="store_true")
    p.add_argument("--full-precision", action="store_true",
                   help="fp32 weights (default bf16)")
    p.add_argument("-offload", "--offload", action="store_true",
                   help="layer weights in pinned host memory, streamed in per layer")
    p.add_argument("-offload-reserve-space-size", "--offload-reserve-space-size",
                   type=int, default=0, help="accepted for parity")
    p.add_argument("--profiling", action="store_true",
                   help="per-phase wall-time report and per-op profile")
    p.add_argument("-auto-parallelism", "--auto-parallelism", dest="auto_parallel",
                   action="store_true",
                   help="search the tensor x pipeline layout over the ranks")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--verbose", action="store_true")
    return p


def main(argv=None):
    args, _legion_flags = build_parser().parse_known_args(argv)
    from flexflow_tpu_torch.config import config
    from flexflow_tpu_torch.serve import LLM

    if args.profiling:
        config.profiling = True

    quant = "int4" if args.int4 else ("int8" if args.int8 else None)
    llm = LLM(args.model, data_type="float32" if args.full_precision else "bfloat16",
              quantization=quant, output_file=args.output_file, device=args.device)
    llm.compile(max_requests_per_batch=args.max_requests_per_batch,
                max_seq_length=args.max_sequence_length,
                max_tokens_per_batch=args.max_tokens_per_batch, offload=args.offload,
                tensor_parallelism_degree=args.tp, data_parallelism_degree=args.dp,
                pipeline_parallelism_degree=args.pp, context_parallel_degree=args.cp,
                auto_parallel=args.auto_parallel)

    prompts = ["Three tips for staying healthy are: "]
    if args.prompt:
        with open(args.prompt) as f:
            prompts = json.load(f)
    results = llm.generate(prompts, max_new_tokens=args.max_new_tokens,
                           temperature=args.temperature, top_p=args.topp, top_k=args.topk)
    if llm.mesh is not None and llm.mesh.rank != 0:
        return 0  # every rank holds the same results
    for r in results:
        print(f"=== guid {r.guid} (steps {r.decoding_steps}, "
              f"latency {r.latency_ms:.1f}ms) ===")
        print(r.prompt + r.output_text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
