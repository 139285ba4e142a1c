"""PyTorch/CUDA port of the HoD (Highways-on-Disk) query system.

A second package beside the JAX reference (``repro``).  It imports
neither JAX nor anything of ``repro``: the numpy host modules it needs
(graph, builder, index layout, metrics) are its own copies, and the two
Pallas kernels of the query path are hand-written CUDA kernels for
Hopper (``kernels/csrc``).  Every entry point runs on the card unless
its caller passes ``device="cpu"``.
"""
