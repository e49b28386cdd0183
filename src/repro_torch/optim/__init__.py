"""AdamW and learning-rate schedules."""
from .adamw import (  # noqa: F401
    OptConfig, adamw_init, adamw_update, global_norm, opt_state_specs,
)
from .schedule import warmup_cosine, constant_lr  # noqa: F401
