"""The PEFT demo (port of ``inference/peft_demo``)."""
