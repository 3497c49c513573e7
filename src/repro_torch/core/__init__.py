"""Gaussians, projection, binning, compositing and the eval renders."""
