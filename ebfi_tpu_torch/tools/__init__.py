"""Probes of the card that the kernels' designs rest on, run by hand with
``python3 -m ebfi_tpu_torch.tools.<name>``."""
