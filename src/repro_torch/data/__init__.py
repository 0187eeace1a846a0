"""Synthetic training data, counterpart of `repro.data`."""
from .pipeline import TokenStream, make_batch

__all__ = ["TokenStream", "make_batch"]
