"""Hand-written CUDA kernels (the HoD query path's ``edge_relax`` and
``tropical_matmul``, the LM decode's ``flash_decode``, DLRM's
``embedding_bag``), each beside its plain PyTorch version (``ref.py``)
and a wrapper (``ops.py``) that picks between them by the device of the
tensors it is given: the plain version for CPU tensors, the kernel for
CUDA tensors."""



def launch_counters() -> dict:
    """Each kernel's wrapper by name; a wrapper's ``launches`` counts its
    launches on the card in this process (where it launches, and nowhere
    else)."""
    from .edge_relax.ops import relax_sweep_
    from .embedding_bag.ops import bag_sum, bag_sum_backward
    from .flash_decode.ops import flash_decode
    from .tropical_matmul.ops import minplus
    return {"edge_relax": relax_sweep_, "tropical_matmul": minplus,
            "flash_decode": flash_decode, "embedding_bag": bag_sum,
            "bag_sum_backward": bag_sum_backward}
