#!/usr/bin/env python
"""Incremental-decoding CLI of the port (flag-compatible with
``inference/incr_decoding.py``).

    python -m flexflow_tpu_torch.inference.incr_decoding -llm-model DIR \\
        -prompt prompts.json --max-new-tokens 16 --device cuda

``--offload`` keeps the layer stack in pinned host memory and streams it
in per layer (``LLM.compile(offload=True)``). Parallelism and
auto-parallelism flags are accepted for compatibility; degrees above 1 are
refused (not in the port yet). Legion resource flags (``-ll:*``) are
ignored.
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
    p.add_argument("-pipeline-parallelism-degree", "--pipeline-parallelism-degree",
                   dest="pp", type=int, default=1)
    p.add_argument("-data-parallelism-degree", "--data-parallelism-degree",
                   dest="dp", type=int, default=1)
    p.add_argument("-context-parallel-degree", "--context-parallel-degree",
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
                   action="store_true", help="accepted for parity (one device)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--verbose", action="store_true")
    return p


def main(argv=None):
    args, _legion_flags = build_parser().parse_known_args(argv)
    if max(args.tp, args.pp, args.dp, args.cp) > 1:
        raise SystemExit("parallelism degrees > 1 are not in the port yet")

    from flexflow_tpu_torch.config import config
    from flexflow_tpu_torch.serve import LLM

    if args.profiling:
        config.profiling = True

    quant = "int4" if args.int4 else ("int8" if args.int8 else None)
    llm = LLM(args.model, data_type="float32" if args.full_precision else "bfloat16",
              quantization=quant, output_file=args.output_file, device=args.device)
    llm.compile(max_requests_per_batch=args.max_requests_per_batch,
                max_seq_length=args.max_sequence_length,
                max_tokens_per_batch=args.max_tokens_per_batch, offload=args.offload)

    prompts = ["Three tips for staying healthy are: "]
    if args.prompt:
        with open(args.prompt) as f:
            prompts = json.load(f)
    results = llm.generate(prompts, max_new_tokens=args.max_new_tokens,
                           temperature=args.temperature, top_p=args.topp, top_k=args.topk)
    for r in results:
        print(f"=== guid {r.guid} (steps {r.decoding_steps}, "
              f"latency {r.latency_ms:.1f}ms) ===")
        print(r.prompt + r.output_text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
