from .llama import (  # noqa: F401
    LlamaConfig,
    LlamaForCausalLM,
    greedy_generate,
    init_random_,
    llama_config_from_hf,
)
