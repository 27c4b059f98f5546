#!/usr/bin/env python
"""Tree-speculative decoding CLI of the port (flag-compatible with
``inference/spec_infer.py``): one verifier plus a draft model, lossless
greedy verification (or stochastic verification with ``--temperature``).

    python -m flexflow_tpu_torch.inference.spec_infer -llm-model DIR \\
        -ssm-model DRAFT_DIR -prompt prompts.json --max-new-tokens 16 --device cuda

More than one ``-ssm-model``, ``--merge-ssm-trees`` and parallelism degrees
above 1 are refused (not in the port yet). Legion resource flags (``-ll:*``)
are ignored.
"""

import argparse
import json
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Speculative inference server (PyTorch port)")
    p.add_argument("-llm-model", "--llm-model", dest="model", required=True,
                   help="local HF model directory of the verifier")
    p.add_argument("-ssm-model", "--ssm-model", dest="ssm_models", action="append",
                   default=[], help="draft model directory (repeatable in the reference)")
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
    p.add_argument("--beam-width", type=int, default=3)
    p.add_argument("--beam-depth", type=int, default=4)
    p.add_argument("--merge-ssm-trees", action="store_true")
    p.add_argument("-tensor-parallelism-degree", "--tensor-parallelism-degree",
                   dest="tp", type=int, default=1)
    p.add_argument("-pipeline-parallelism-degree", "--pipeline-parallelism-degree",
                   dest="pp", type=int, default=1)
    p.add_argument("--fusion", action="store_true", help="accepted for parity")
    p.add_argument("-4bit-quantization", "--4bit-quantization", dest="int4",
                   action="store_true")
    p.add_argument("-8bit-quantization", "--8bit-quantization", dest="int8",
                   action="store_true")
    p.add_argument("--full-precision", action="store_true",
                   help="fp32 weights (default bf16)")
    p.add_argument("--profiling", action="store_true",
                   help="per-phase wall-time report and per-op profile")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--verbose", action="store_true")
    return p


def main(argv=None):
    args, _legion_flags = build_parser().parse_known_args(argv)
    if not args.ssm_models:
        print("error: at least one -ssm-model required", file=sys.stderr)
        return 2
    if max(args.tp, args.pp) > 1:
        raise SystemExit("parallelism degrees > 1 are not in the port yet")

    from flexflow_tpu_torch.config import config
    from flexflow_tpu_torch.serve import LLM, SSM

    if args.profiling:
        config.profiling = True

    quant = "int4" if args.int4 else ("int8" if args.int8 else None)
    dtype = "float32" if args.full_precision else "bfloat16"
    llm = LLM(args.model, data_type=dtype, quantization=quant, output_file=args.output_file,
              device=args.device)
    ssms = [SSM(m, data_type=dtype, device=args.device) for m in args.ssm_models]
    llm.compile(max_requests_per_batch=args.max_requests_per_batch,
                max_seq_length=args.max_sequence_length,
                max_tokens_per_batch=args.max_tokens_per_batch,
                beam_width=args.beam_width, beam_depth=args.beam_depth, ssms=ssms,
                merge_ssm_trees=args.merge_ssm_trees)

    prompts = ["Three tips for staying healthy are: "]
    if args.prompt:
        with open(args.prompt) as f:
            prompts = json.load(f)
    results = llm.generate(prompts, max_new_tokens=args.max_new_tokens,
                           temperature=args.temperature, top_p=args.topp, top_k=args.topk)
    for r in results:
        print(f"=== guid {r.guid} (steps {r.decoding_steps}, "
              f"latency {r.latency_ms:.1f}ms, "
              f"verified/step {llm.rm.mean_verified_tokens_per_step:.2f}) ===")
        print(r.prompt + r.output_text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
