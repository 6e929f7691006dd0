"""Tools run by hand with ``python3 -m ebfi_tpu_torch.tools.<name>``: the
export of the serving call (``export``), an A/B timing of checkouts
(``ab_serve_train``) and probes of the card that the kernels' designs rest
on (``tf32_wgmma_rate``)."""
