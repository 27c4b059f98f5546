#!/usr/bin/env python
"""PEFT CLI of the port (flag-compatible with ``inference/peft.py``): serve
prompts through a registered LoRA adapter.

    python -m flexflow_tpu_torch.inference.peft -llm-model DIR -enable-peft \\
        -peft-model ADAPTER_DIR -prompt prompts.json --max-new-tokens 16

The adapter is an HF PEFT directory (``-peft-model``) or, without one, a
fresh ``--lora-rank`` / ``--lora-alpha`` adapter on wq and wv (B zero: the
base model's output). Co-scheduled finetuning (``-finetuning-dataset``) waits
for the training slice. Runs on the card unless ``--device cpu`` is given.
Legion resource flags (``-ll:*``) are ignored.
"""

import argparse
import json
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="PEFT serving (PyTorch port)")
    p.add_argument("-llm-model", "--llm-model", dest="model", required=True)
    p.add_argument("-enable-peft", "--enable-peft", dest="enable_peft", action="store_true")
    p.add_argument("-peft-model", "--peft-model", dest="peft_model", default="",
                   help="HF PEFT adapter directory")
    p.add_argument("-prompt", "--prompt", dest="prompt", default="")
    p.add_argument("-finetuning-dataset", "--finetuning-dataset", dest="dataset", default="",
                   help="json file with a list of training strings (not in the port yet)")
    p.add_argument("-output-file", "--output-file", dest="output_file", default="")
    p.add_argument("--max-requests-per-batch", type=int, default=8)
    p.add_argument("--max-tokens-per-batch", type=int, default=128)
    p.add_argument("--max-sequence-length", type=int, default=256)
    p.add_argument("--max-new-tokens", type=int, default=128)
    p.add_argument("--max-training-steps", type=int, default=2, help="accepted for parity")
    p.add_argument("--learning-rate", type=float, default=1e-3, help="accepted for parity")
    p.add_argument("--lora-rank", type=int, default=8)
    p.add_argument("--lora-alpha", type=float, default=16.0)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--topp", "--top-p", dest="topp", type=float, default=1.0)
    p.add_argument("--do-sample", action="store_true")
    p.add_argument("-tensor-parallelism-degree", "--tensor-parallelism-degree",
                   dest="tp", type=int, default=1)
    p.add_argument("-data-parallelism-degree", "--data-parallelism-degree",
                   dest="dp", type=int, default=1)
    p.add_argument("--full-precision", action="store_true", help="fp32 weights (default bf16)")
    p.add_argument("--save-peft", dest="save_peft", default="",
                   help="export the finetuned adapter to this dir (with finetuning only)")
    p.add_argument("--profiling", action="store_true",
                   help="per-phase wall-time report and per-op profile")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--verbose", action="store_true")
    return p


def main(argv=None):
    args, _legion_flags = build_parser().parse_known_args(argv)
    if not args.enable_peft and args.peft_model:
        print("PEFT model id passed, but PEFT is not enabled", file=sys.stderr)
        return 1
    if args.enable_peft and args.dataset:
        raise NotImplementedError(
            "co-scheduled LoRA finetuning (-finetuning-dataset) is not in the port yet: it waits "
            "for the training slice (ROADMAP.md Queue A, A5b)")
    if max(args.tp, args.dp) > 1:
        raise SystemExit("parallelism degrees > 1 are not in the port yet")

    from flexflow_tpu_torch.config import config
    from flexflow_tpu_torch.peft.lora import LoraConfig
    from flexflow_tpu_torch.serve import LLM

    if args.profiling:
        config.profiling = True

    llm = LLM(args.model, data_type="float32" if args.full_precision else "bfloat16",
              output_file=args.output_file, device=args.device)
    serve_adapter = -1
    if args.enable_peft:
        serve_adapter = llm.register_peft_adapter(
            args.peft_model or LoraConfig(rank=args.lora_rank, alpha=args.lora_alpha,
                                          target_modules=("wq", "wv")))
    llm.compile(max_requests_per_batch=args.max_requests_per_batch,
                max_seq_length=args.max_sequence_length,
                max_tokens_per_batch=args.max_tokens_per_batch)

    prompts = ["Three tips for staying healthy are: "]
    if args.prompt:
        with open(args.prompt) as f:
            prompts = json.load(f)
    results = llm.generate(prompts, max_new_tokens=args.max_new_tokens,
                           temperature=args.temperature if args.do_sample else 0.0,
                           top_p=args.topp, adapter_id=serve_adapter)
    for r in results:
        print(f"=== guid {r.guid} (steps {r.decoding_steps}, "
              f"latency {r.latency_ms:.1f}ms) ===")
        print(r.prompt + r.output_text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
