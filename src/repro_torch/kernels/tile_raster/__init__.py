from repro_torch.kernels.tile_raster.ops import rasterize_tiles

__all__ = ["rasterize_tiles"]
