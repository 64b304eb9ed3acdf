"""Command-line apps of the port (``python -m spef_tpu_torch.apps.<name>``)."""
