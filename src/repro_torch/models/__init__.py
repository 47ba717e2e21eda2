"""The port's language model: the captioner's decoder-only serving path."""
