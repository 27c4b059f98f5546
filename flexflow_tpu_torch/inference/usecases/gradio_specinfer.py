#!/usr/bin/env python
"""Gradio UI over speculative decoding (mirror of
``inference/usecases/gradio_specinfer.py``; one draft model). Needs
``gradio``, imported when the UI starts.

    FF_MODEL_DIR=... FF_SSM_DIRS=... python -m flexflow_tpu_torch.inference.usecases.gradio_specinfer
"""

import os


def main():
    import gradio as gr

    from flexflow_tpu_torch.serve import LLM, SSM

    device = os.environ.get("FF_DEVICE")
    llm = LLM(os.environ["FF_MODEL_DIR"], device=device)
    ssms = [SSM(d, device=device) for d in os.environ["FF_SSM_DIRS"].split(",") if d.strip()]
    llm.compile(max_requests_per_batch=int(os.environ.get("FF_MAX_BATCH", 4)),
                max_seq_length=int(os.environ.get("FF_MAX_SEQ", 512)), ssms=ssms)
    llm.start_server()

    def generate(prompt, max_new_tokens):
        [res] = llm.generate(prompt, max_new_tokens=int(max_new_tokens))
        return res.output_text

    gr.Interface(
        fn=generate,
        inputs=[gr.Textbox(label="Prompt"),
                gr.Slider(1, 512, value=128, label="Max new tokens")],
        outputs=gr.Textbox(label="Output"),
        title="flexflow_tpu_torch speculative decoding (lossless)",
    ).launch()


if __name__ == "__main__":
    main()
