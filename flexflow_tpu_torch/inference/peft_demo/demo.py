#!/usr/bin/env python
"""PEFT demo (port of ``inference/peft_demo/demo.py``): finetune a LoRA
adapter for 4 steps on a four-line dataset while serving a prompt through
a fresh adapter (B zero: the base model's text), then save the trained
adapter, through the port's PEFT CLI (``flexflow_tpu_torch.inference.
peft``) with the JAX demo's dataset, prompt and flags.

    FF_MODEL_DIR=... python -m flexflow_tpu_torch.inference.peft_demo.demo [--device cpu]

Arguments are passed on to the PEFT CLI after the demo's own (the device,
``--full-precision``).
"""

import json
import os
import sys
import tempfile


def main(argv=None):
    from flexflow_tpu_torch.inference.peft import main as peft_main

    model = os.environ["FF_MODEL_DIR"]
    extra = list(sys.argv[1:] if argv is None else argv)
    with tempfile.TemporaryDirectory() as d:
        dataset = os.path.join(d, "dataset.json")
        prompts = os.path.join(d, "prompts.json")
        with open(dataset, "w") as f:
            json.dump(["The quick brown fox jumps over the lazy dog."] * 4, f)
        with open(prompts, "w") as f:
            json.dump(["The quick brown"], f)
        return peft_main([
            "-llm-model", model, "-enable-peft",
            "-prompt", prompts, "-finetuning-dataset", dataset,
            "--max-new-tokens", "16", "--max-training-steps", "4",
            "--save-peft", os.path.join(d, "adapter"),
        ] + extra)


if __name__ == "__main__":
    raise SystemExit(main())
