"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version (``ref.py``) and a wrapper (``ops.py``) that picks by device."""
