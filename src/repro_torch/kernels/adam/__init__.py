from repro_torch.kernels.adam.ops import launch
from repro_torch.kernels.adam.ref import adam_ref

__all__ = ["adam_ref", "launch"]
