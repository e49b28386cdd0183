"""Synthetic HAR sensor streams."""
from .sensors import (  # noqa: F401
    har_window, har_windows, har_stream, class_signatures,
)
