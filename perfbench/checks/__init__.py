"""Checks of the benchmark itself, run by path (not collected by pytest)."""
