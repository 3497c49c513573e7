from repro_torch.kernels.gsproject.ops import project_packed

__all__ = ["project_packed"]
