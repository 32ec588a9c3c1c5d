"""AdamW and learning-rate schedules (port of ``repro/optim``)."""

from repro_torch.optim.adamw import (OptState, adamw_init, adamw_update,
                                     adamw_update_, clip_by_global_norm, decay_mask,
                                     opt_state_spec)
from repro_torch.optim.schedules import constant, cosine, wsd

__all__ = ["OptState", "adamw_init", "adamw_update", "adamw_update_",
           "clip_by_global_norm", "constant", "cosine", "decay_mask", "opt_state_spec",
           "wsd"]
