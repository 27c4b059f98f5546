#!/usr/bin/env python
"""Gradio chat UI over the port (mirror of ``inference/usecases/gradio_chat.py``).
Needs ``gradio``, imported when the UI starts.

    FF_MODEL_DIR=... python -m flexflow_tpu_torch.inference.usecases.gradio_chat
"""

import os


def main():
    import gradio as gr

    from flexflow_tpu_torch.serve import LLM

    llm = LLM(os.environ["FF_MODEL_DIR"], device=os.environ.get("FF_DEVICE"))
    llm.compile(max_requests_per_batch=int(os.environ.get("FF_MAX_BATCH", 4)),
                max_seq_length=int(os.environ.get("FF_MAX_SEQ", 1024)))

    def respond(message, history):
        messages = []
        for user, assistant in history:
            messages.append({"role": "user", "content": user})
            messages.append({"role": "assistant", "content": assistant})
        messages.append({"role": "user", "content": message})
        try:
            prompt = llm.tokenizer.apply_chat_template(messages, tokenize=False,
                                                       add_generation_prompt=True)
        except Exception:
            prompt = "\n".join(f"{m['role']}: {m['content']}" for m in messages)
        [res] = llm.generate(prompt, max_new_tokens=256)
        return res.output_text

    gr.ChatInterface(respond, title="flexflow_tpu_torch chat").launch()


if __name__ == "__main__":
    main()
