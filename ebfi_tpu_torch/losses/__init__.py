"""Training losses of the port (``ebfi_tpu/losses/restore.py``).  LPIPS
and the adversarial, flow and reconstruction losses are not ported yet
(ROADMAP.md, queue A)."""
from .restore import census_loss, charbonnier_loss, l1_loss, laplacian_loss, mse_loss

__all__ = ["laplacian_loss", "census_loss", "charbonnier_loss", "mse_loss", "l1_loss"]
