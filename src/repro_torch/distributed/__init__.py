"""Placement helpers for the port's fleet tier (a subset of
``repro.distributed``)."""
