"""Synthetic scene data (a numpy copy of ``repro.data.scenes``)."""
