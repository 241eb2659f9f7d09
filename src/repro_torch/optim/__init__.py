from repro_torch.optim.adamw import (
    adafactor_init,
    adafactor_update,
    adamw_init,
    adamw_update,
    freeze_mask,
    lr_scale_mask,
    make_schedule,
    optimizer_init,
    optimizer_update,
)

__all__ = [
    "adafactor_init",
    "adafactor_update",
    "adamw_init",
    "adamw_update",
    "freeze_mask",
    "lr_scale_mask",
    "make_schedule",
    "optimizer_init",
    "optimizer_update",
]
