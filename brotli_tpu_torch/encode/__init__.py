"""Brotli encode pipeline (quality-tiered, host golden path + device kernels)."""

from .api import Encoder, encode, encode_fragment

__all__ = ["encode", "Encoder", "encode_fragment"]
