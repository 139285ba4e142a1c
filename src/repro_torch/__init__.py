"""PyTorch/CUDA port of the HoD (Highways-on-Disk) query system and of
the serving paths of its glm4-9b and dlrm-rm2 models.

A second package beside the JAX reference (``repro``).  It imports
neither JAX nor anything of ``repro``: the numpy host modules it needs
(graph, builder, index layout, metrics, configs) are its own copies, and
every Pallas kernel of the reference is a hand-written CUDA kernel for
Hopper (``kernels/csrc``).  Every entry point runs on the card unless
its caller passes ``device="cpu"``.
"""
