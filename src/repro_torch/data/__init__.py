from repro_torch.data.views import ViewDataset

__all__ = ["ViewDataset"]
