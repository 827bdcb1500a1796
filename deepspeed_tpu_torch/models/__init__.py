from .registry import (MODEL_CONFIGS, bloom_config, get_model, gpt2_config,  # noqa: F401
                       gptj_config, llama_config, mistral_config, neox_config,
                       opt_config, qwen2_config)
from .transformer import CausalLM, TransformerConfig  # noqa: F401
