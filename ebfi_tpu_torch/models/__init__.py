"""Model family of the port (standard paths of ``ebfi_tpu.models``)."""
from .control import ResidualControl
from .convert import (discriminator_params_from_jax, lpips_params_from_jax, params_from_jax,
                      params_from_reference, superslomo_params_from_jax)
from .evfi import EVFIAutoEx
from .exposure import ExposureDecision
from .factory import build_model, init_weights
from .layers import ConvLayer, SEGating
from .modification import Modification
from .unet3d import UNet3d18

__all__ = [
    "ConvLayer",
    "SEGating",
    "ExposureDecision",
    "ResidualControl",
    "Modification",
    "UNet3d18",
    "EVFIAutoEx",
    "build_model",
    "init_weights",
    "params_from_jax",
    "lpips_params_from_jax",
    "discriminator_params_from_jax",
    "params_from_reference",
    "superslomo_params_from_jax",
]
