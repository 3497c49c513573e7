"""repro_torch — the PyTorch/CUDA port of the distributed 3D Gaussian
splatting system, beside the JAX package ``repro``.

It mirrors ``repro``'s subpackage layout and public layouts (packed splats
``(N, 11)``, images ``(H, W, 3)``). Plain tensor code is PyTorch; the TPU's
Pallas kernels become hand-written CUDA kernels for Hopper (``kernels/``),
chosen by the device of the tensors they are given. The package imports
neither JAX nor anything of ``repro``.
"""
