#!/usr/bin/env python
"""Interactive chat CLI of the port (mirror of ``inference/chat.py``):
applies the tokenizer's chat template per turn (``role: content`` lines when
it has none) and serves each turn.

    python -m flexflow_tpu_torch.inference.chat -llm-model DIR [--device cpu]
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("-llm-model", "--llm-model", dest="model", required=True)
    p.add_argument("--max-sequence-length", type=int, default=1024)
    p.add_argument("--max-new-tokens", type=int, default=256)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--system-prompt", default="You are a helpful assistant.")
    p.add_argument("--full-precision", action="store_true")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args, _ = p.parse_known_args(argv)

    from flexflow_tpu_torch.serve import LLM

    llm = LLM(args.model, data_type="float32" if args.full_precision else "bfloat16",
              device=args.device)
    llm.compile(max_requests_per_batch=1, max_seq_length=args.max_sequence_length)
    tok = llm.tokenizer

    messages = [{"role": "system", "content": args.system_prompt}]
    print("chat ready — type 'exit' to quit")
    while True:
        try:
            user = input("you> ").strip()
        except EOFError:
            break
        if user in ("exit", "quit", ""):
            break
        messages.append({"role": "user", "content": user})
        try:
            prompt = tok.apply_chat_template(messages, tokenize=False,
                                             add_generation_prompt=True)
        except Exception:  # a tokenizer without a chat template
            prompt = "\n".join(f"{m['role']}: {m['content']}" for m in messages)
            prompt += "\nassistant:"
        [res] = llm.generate(prompt, max_new_tokens=args.max_new_tokens,
                             temperature=args.temperature)
        print(f"assistant> {res.output_text}")
        messages.append({"role": "assistant", "content": res.output_text})
    return 0


if __name__ == "__main__":
    sys.exit(main())
