from repro_torch.optim.adam import AdamState, adam_init, adam_update
from repro_torch.optim.schedules import expon_lr, grendel_lr_scale

__all__ = ["AdamState", "adam_init", "adam_update", "expon_lr", "grendel_lr_scale"]
