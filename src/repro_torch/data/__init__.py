"""Synthetic HAR and bearing-vibration sensor streams."""
from .sensors import (  # noqa: F401
    har_window, har_windows, har_stream, har_dataset, class_signatures,
    bearing_window, bearing_windows, bearing_stream, bearing_dataset,
)
