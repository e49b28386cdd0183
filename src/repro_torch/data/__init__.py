"""Synthetic HAR and bearing-vibration sensor streams, and the synthetic LM
token pipeline."""
from .sensors import (  # noqa: F401
    har_window, har_windows, har_stream, har_dataset, class_signatures,
    bearing_window, bearing_windows, bearing_stream, bearing_dataset,
)
from .lm import lm_batches, LMTask  # noqa: F401
