"""Step functions and the trainer of the port (``repro_torch.launch``)."""
