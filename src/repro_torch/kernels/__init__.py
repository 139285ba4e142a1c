"""Hand-written CUDA kernels (the HoD query path's ``edge_relax`` and
``tropical_matmul``, the LM decode's ``flash_decode``, DLRM's
``embedding_bag``), each beside its plain PyTorch version (``ref.py``)
and a wrapper (``ops.py``) that picks between them by the device of the
tensors it is given: the plain version for CPU tensors, the kernel for
CUDA tensors.

On fake tensors (``torch._subclasses.fake_tensor.FakeTensor``, the dry
run's) the three kernels of the model cells (``flash_decode``,
``bag_sum``, ``bag_sum_backward``) take a fake form instead: it builds
nothing and launches nothing, returns an output of the kernel's shape
and dtype, and reports the call to :data:`FAKE_LISTENERS` with the
bytes and operations of the kernel's cost function (``*_cost`` in each
``ops.py``, the same formulas that give ``chip_smoke.py`` its bounds)."""

#: Callables ``listener(name, nbytes, ops, dtype)`` that hear of each call
#: a fake form stands for, by its :func:`launch_counters` name;
#: ``launch.op_analysis.OpAnalysis`` adds itself while it runs.
FAKE_LISTENERS: list = []


def note_fake_launch(name: str, nbytes: float, ops: float, dtype) -> None:
    """A fake form's call of kernel ``name``: tell every listener."""
    for listener in list(FAKE_LISTENERS):
        listener(name, nbytes, ops, dtype)


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
