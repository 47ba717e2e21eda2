"""Placement helpers of the fleet tier and gradient compression (a subset of
``repro.distributed``)."""
