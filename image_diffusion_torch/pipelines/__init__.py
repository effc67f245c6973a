"""Sampling pipelines."""

from .diffusion import DiffusionPipeline, to_uint8

__all__ = ["DiffusionPipeline", "to_uint8"]
