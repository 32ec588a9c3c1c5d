"""Serving: the batched engine and its dispatch histograms."""
