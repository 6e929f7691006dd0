"""Training losses of the port (``ebfi_tpu/losses``): restoration losses,
LPIPS, the adversarial pack, the flow losses and brightness constancy."""
from .adversarial import AdversarialLoss, AdvState
from .flow import EventWarping, averaged_iwe, deblur_events
from .lpips import LPIPS, load_lpips_params
from .reconstruction import BrightnessConstancy
from .restore import census_loss, charbonnier_loss, l1_loss, laplacian_loss, mse_loss

__all__ = ["AdversarialLoss", "AdvState", "EventWarping", "averaged_iwe", "deblur_events",
           "BrightnessConstancy", "laplacian_loss", "census_loss", "charbonnier_loss",
           "mse_loss", "l1_loss", "LPIPS", "load_lpips_params"]
