"""Runnable programs of the port (python3 -m multistark_tpu_torch.examples.<name>)."""
