"""The paper's HAR edge classifier."""
from .har import (  # noqa: F401
    HARConfig, har_init, har_apply, har_apply_quantized,
    har_apply_quantized_nodes, quantize_params,
)
