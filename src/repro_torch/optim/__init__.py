"""AdamW and learning-rate schedules."""
from .adamw import OptConfig, adamw_init, adamw_update, global_norm  # noqa: F401
from .schedule import warmup_cosine, constant_lr  # noqa: F401
