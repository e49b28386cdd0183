"""Workload configurations: the paper's HAR and bearing classifiers and
Seeker's system knobs (:mod:`.seeker_har`), and the architecture registry of
the language models.

Each architecture module exposes

* ``CONFIG``  — the published configuration (full size),
* ``SMOKE``   — a reduced same-family config for CPU tests,
* ``LONG_CONTEXT_OK`` — whether the arch runs the long-context cell
  (sub-quadratic attention only),
* ``IS_DECODER`` — has a decode step (all ten do).

``get_config(name)`` / ``get_smoke(name)`` / ``ARCHS`` are the public API,
the same names and values as :mod:`repro.configs`.
"""
from __future__ import annotations

import importlib

__all__ = ["ARCHS", "get_config", "get_smoke", "long_context_ok"]

ARCHS = (
    "gemma-2b", "gemma3-12b", "tinyllama-1.1b", "yi-34b", "recurrentgemma-2b",
    "deepseek-moe-16b", "grok-1-314b", "whisper-small", "mamba2-130m",
    "qwen2-vl-2b",
)

_MODULES = {
    "gemma-2b": "gemma_2b",
    "gemma3-12b": "gemma3_12b",
    "tinyllama-1.1b": "tinyllama_1_1b",
    "yi-34b": "yi_34b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "grok-1-314b": "grok_1_314b",
    "whisper-small": "whisper_small",
    "mamba2-130m": "mamba2_130m",
    "qwen2-vl-2b": "qwen2_vl_2b",
}


def _mod(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; options: {ARCHS}")
    return importlib.import_module(f"{__name__}.{_MODULES[name]}")


def get_config(name: str):
    return _mod(name).CONFIG


def get_smoke(name: str):
    return _mod(name).SMOKE


def long_context_ok(name: str) -> bool:
    return getattr(_mod(name), "LONG_CONTEXT_OK", False)
