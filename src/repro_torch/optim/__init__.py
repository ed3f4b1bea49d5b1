from repro_torch.optim.optimizer import (
    AdamWState,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    cosine_schedule,
)

__all__ = ["AdamWState", "adamw_init", "adamw_update", "clip_by_global_norm", "cosine_schedule"]
