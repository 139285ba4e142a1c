"""Hand-written CUDA kernels (the HoD query path's ``edge_relax`` and
``tropical_matmul``, the LM decode's ``flash_decode``, DLRM's
``embedding_bag``), each beside its plain PyTorch version (``ref.py``)
and a wrapper (``ops.py``) that picks between them by the device of the
tensors it is given: the plain version for CPU tensors, the kernel for
CUDA tensors."""
