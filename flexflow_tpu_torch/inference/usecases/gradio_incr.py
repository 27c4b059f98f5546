#!/usr/bin/env python
"""Gradio text-generation UI over incremental decoding (mirror of
``inference/usecases/gradio_incr.py``). Needs ``gradio``, imported when the
UI starts.

    FF_MODEL_DIR=... python -m flexflow_tpu_torch.inference.usecases.gradio_incr
"""

import os


def main():
    import gradio as gr

    from flexflow_tpu_torch.serve import LLM

    llm = LLM(os.environ["FF_MODEL_DIR"], device=os.environ.get("FF_DEVICE"))
    llm.compile(max_requests_per_batch=int(os.environ.get("FF_MAX_BATCH", 4)),
                max_seq_length=int(os.environ.get("FF_MAX_SEQ", 512)))
    llm.start_server()

    def generate(prompt, max_new_tokens, temperature):
        [res] = llm.generate(prompt, max_new_tokens=int(max_new_tokens),
                             temperature=float(temperature))
        return res.output_text

    gr.Interface(
        fn=generate,
        inputs=[gr.Textbox(label="Prompt"),
                gr.Slider(1, 512, value=128, label="Max new tokens"),
                gr.Slider(0.0, 2.0, value=0.0, label="Temperature")],
        outputs=gr.Textbox(label="Output"),
        title="flexflow_tpu_torch incremental decoding",
    ).launch()


if __name__ == "__main__":
    main()
