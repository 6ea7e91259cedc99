"""Command-line tools of the port (``python -m recommendit_tpu_torch.scripts.<name>``)."""
