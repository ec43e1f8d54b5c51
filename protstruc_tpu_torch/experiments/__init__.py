"""Measurement scripts of the port, run on the card (``python -m protstruc_tpu_torch.experiments.<name>``)."""
