"""Parameter-efficient finetuning: LoRA adapters for serving and their
co-scheduled finetuning (port of ``flexflow_tpu/peft``)."""

from flexflow_tpu_torch.peft.lora import (  # noqa: F401
    LoraConfig,
    RoutedLora,
    hf_module_to_key,
    init_lora_params,
    lora_scaling,
    merge_lora,
    route_lora,
    unroute_lora,
)
