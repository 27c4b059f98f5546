#!/usr/bin/env python
"""Streamlit chat demo over the port's HTTP endpoint (mirror of
``inference/streamlit/app.py``). Needs ``streamlit``, imported when the app
runs. Start the server first, then the UI:

    python -m flexflow_tpu_torch.inference.entrypoint.http_server -llm-model DIR --port 8000 &
    streamlit run flexflow_tpu_torch/inference/streamlit/app.py
"""

import json
import os
import urllib.request


def main():
    import streamlit as st

    st.title("flexflow_tpu_torch chat")
    endpoint = os.environ.get("FF_ENDPOINT", "http://localhost:8000/generate")

    if "history" not in st.session_state:
        st.session_state.history = []
    for role, text in st.session_state.history:
        st.chat_message(role).write(text)

    prompt = st.chat_input("Say something")
    if prompt:
        st.chat_message("user").write(prompt)
        body = json.dumps({"prompt": prompt, "max_new_tokens": 128}).encode()
        req = urllib.request.Request(endpoint, data=body,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req) as resp:
            out = json.load(resp)["output"]
        st.chat_message("assistant").write(out)
        st.session_state.history += [("user", prompt), ("assistant", out)]


if __name__ == "__main__":
    main()
