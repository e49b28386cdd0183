"""LM training: train steps (plain, microbatched, coreset-compressed) and
the fault-tolerant loop."""
from .step import (  # noqa: F401
    TrainHyper, cross_entropy, make_loss_fn, make_train_step,
    make_compressed_train_step, init_train_state, abstract_train_state,
    train_state_specs, value_and_grad,
)
from .loop import TrainLoopConfig, run_training, PreemptionError  # noqa: F401
