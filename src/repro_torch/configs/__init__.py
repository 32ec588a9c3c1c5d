"""Architecture configs (copied from ``repro.configs``; no import of it)."""

from repro_torch.configs.base import ArchConfig, get_config, list_archs, register
from repro_torch.configs.archs import PAPER_VECTOR_LEN, cut_layers, smoke_config

__all__ = ["ArchConfig", "PAPER_VECTOR_LEN", "cut_layers", "get_config",
           "list_archs", "register", "smoke_config"]
