"""Conversions between the JAX package's weight trees and the port's."""

from .from_jax import unet_flax_params, unet_state_dict, vae_flax_variables, vae_state_dict

__all__ = ["unet_flax_params", "unet_state_dict", "vae_flax_variables", "vae_state_dict"]
