"""Command-line entry points of the PyTorch port (``python -m mop_tpu_torch.cli.<name>``)."""
