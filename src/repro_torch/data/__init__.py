"""Synthetic token pipeline (port of ``repro/data``)."""

from repro_torch.data.pipeline import Prefetcher, SyntheticLM, make_batch

__all__ = ["Prefetcher", "SyntheticLM", "make_batch"]
