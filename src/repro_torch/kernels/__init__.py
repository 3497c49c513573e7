"""Hand-written CUDA kernels of the port, one directory per TPU kernel.

Each directory holds ``<name>.cu`` (the kernel and its plain C launcher),
``ops.py`` (the wrapper: checks, layout, dispatch by tensor device, launch
count) and ``ref.py`` (the plain PyTorch version of the same function).
``_lib.py`` builds every ``.cu`` into one shared library on first use.
"""
