"""The synthetic token pipeline (``pipeline``), a copy of the reference's
``repro.data`` with an upload step to a torch device."""

from .pipeline import Prefetcher, SyntheticTokens, make_batch, to_device

__all__ = ["Prefetcher", "SyntheticTokens", "make_batch", "to_device"]
