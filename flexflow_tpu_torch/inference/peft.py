#!/usr/bin/env python
"""PEFT CLI of the port (flag-compatible with ``inference/peft.py``): serve
prompts through a registered LoRA adapter while a co-scheduled finetuning
session trains a second adapter slot.

    python -m flexflow_tpu_torch.inference.peft -llm-model DIR -enable-peft \\
        -peft-model ADAPTER_DIR -prompt prompts.json --max-new-tokens 16 \\
        -finetuning-dataset texts.json --max-training-steps 8 --save-peft OUT_DIR

The served adapter is an HF PEFT directory (``-peft-model``) or, without
one, a fresh ``--lora-rank`` / ``--lora-alpha`` adapter on wq and wv (B
zero: the base model's output). With ``-finetuning-dataset`` (a json list of
strings) a second slot of the first adapter's config is trained by SGD, one
step per scheduler iteration of ``generate`` and the rest after it, up to
``--max-training-steps``; ``--save-peft`` exports it as an HF PEFT
directory. Runs on the card unless ``--device cpu`` is given. Legion
resource flags (``-ll:*``) are ignored.

``-tensor-parallelism-degree`` / ``-data-parallelism-degree`` serve and
finetune over that many ranks, one process each under ``torchrun`` (as
``incr_decoding``); rank 0 prints and writes ``--save-peft``:

    torchrun --standalone --nproc-per-node 2 -m flexflow_tpu_torch.inference.peft \
        -llm-model DIR -enable-peft ... --device cpu -tensor-parallelism-degree 2
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
                   help="json file with a list of training strings")
    p.add_argument("-output-file", "--output-file", dest="output_file", default="")
    p.add_argument("--max-requests-per-batch", type=int, default=8)
    p.add_argument("--max-tokens-per-batch", type=int, default=128)
    p.add_argument("--max-sequence-length", type=int, default=256)
    p.add_argument("--max-new-tokens", type=int, default=128)
    p.add_argument("--max-training-steps", type=int, default=2)
    p.add_argument("--learning-rate", type=float, default=1e-3, help="finetuning SGD lr")
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
                   help="export the finetuned adapter to this dir")
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

    import numpy as np

    from flexflow_tpu_torch.config import config
    from flexflow_tpu_torch.peft.finetune import FinetuneSession
    from flexflow_tpu_torch.peft.lora import LoraConfig
    from flexflow_tpu_torch.serve import LLM

    if args.profiling:
        config.profiling = True

    llm = LLM(args.model, data_type="float32" if args.full_precision else "bfloat16",
              output_file=args.output_file, device=args.device)
    serve_adapter = finetune_adapter = -1
    if args.enable_peft:
        base_cfg = LoraConfig(rank=args.lora_rank, alpha=args.lora_alpha,
                              target_modules=("wq", "wv"), learning_rate=args.learning_rate,
                              optimizer="sgd")
        # the served adapter, and a separate slot to train
        serve_adapter = llm.register_peft_adapter(args.peft_model or base_cfg)
        finetune_adapter = llm.register_peft_adapter(
            llm._peft[0][0] if args.peft_model else base_cfg)
    llm.compile(max_requests_per_batch=args.max_requests_per_batch,
                max_seq_length=args.max_sequence_length,
                max_tokens_per_batch=args.max_tokens_per_batch,
                tensor_parallelism_degree=args.tp, data_parallelism_degree=args.dp)
    speaks = llm.mesh is None or llm.mesh.rank == 0  # every rank holds the same results

    session = None
    if args.enable_peft and args.dataset:
        with open(args.dataset) as f:
            texts = json.load(f)
        pairs = []
        for t in texts:
            ids = llm.tokenizer(t, return_tensors=None)["input_ids"][: args.max_sequence_length]
            if len(ids) < 2:
                continue
            pairs.append((np.asarray([ids[:-1]], np.int32), np.asarray([ids[1:]], np.int32)))
        # --max-training-steps exactly (whole epochs alone would round up)
        session = FinetuneSession(
            llm.spec, llm.lora_config, finetune_adapter, pairs,
            epochs=max(1, -(-args.max_training_steps // max(len(pairs), 1))),
            max_steps=args.max_training_steps)
        llm.rm.register_finetune(session)

    prompts = ["Three tips for staying healthy are: "]
    if args.prompt:
        with open(args.prompt) as f:
            prompts = json.load(f)
    results = llm.generate(prompts, max_new_tokens=args.max_new_tokens,
                           temperature=args.temperature if args.do_sample else 0.0,
                           top_p=args.topp, adapter_id=serve_adapter)
    for r in results if speaks else ():
        print(f"=== guid {r.guid} (steps {r.decoding_steps}, "
              f"latency {r.latency_ms:.1f}ms) ===")
        print(r.prompt + r.output_text)
    if session is not None:
        # the finetuning steps serving left, after it drained
        while not session.tick(llm.rm.engine):
            pass
        if speaks:
            print(f"[Finetune] steps {len(session.losses)} "
                  f"losses {['%.4f' % v for v in session.losses]}")
        if args.save_peft:
            llm.save_peft_adapter(args.save_peft, finetune_adapter)
            if speaks:
                print(f"[Finetune] adapter saved to {args.save_peft}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
