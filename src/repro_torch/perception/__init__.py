"""Perception stand-ins (the oracle embedder)."""
