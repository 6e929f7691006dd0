"""Training losses and LPIPS of the port (``ebfi_tpu/losses/restore.py``,
``lpips.py``).  The adversarial, flow and reconstruction losses are not
ported yet (ROADMAP.md, queue A)."""
from .lpips import LPIPS, load_lpips_params
from .restore import census_loss, charbonnier_loss, l1_loss, laplacian_loss, mse_loss

__all__ = ["laplacian_loss", "census_loss", "charbonnier_loss", "mse_loss", "l1_loss",
           "LPIPS", "load_lpips_params"]
