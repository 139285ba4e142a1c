"""Hand-written CUDA kernels for the HoD query path, each beside its
plain PyTorch version (``ref.py``) and a wrapper (``ops.py``) that
picks between them by the device of the tensors it is given: the plain
version for CPU tensors, the kernel for CUDA tensors."""
