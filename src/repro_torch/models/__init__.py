"""The paper's HAR edge classifier, and the language models (config,
layers, flash walks, the MoE FFN, the RG-LRU and SSD mixers, transformer
with whisper's encoder and qwen2-vl's M-RoPE)."""
from .config import ModelConfig, MoEConfig, pattern_runs  # noqa: F401
from .har import (  # noqa: F401
    HARConfig, har_init, har_apply, har_apply_quantized,
    har_apply_quantized_nodes, quantize_params,
)
from .transformer import (  # noqa: F401
    abstract_cache, abstract_params, build_mrope_positions, cache_specs,
    compute_params, decode_step, forward, init_cache, init_params,
    model_param_shapes, param_specs,
)
