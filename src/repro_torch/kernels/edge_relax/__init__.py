from .ops import relax_sweep_  # noqa: F401
from .ref import relax_bucketed_ref, relax_sweep_ref_  # noqa: F401
from .sweep import Sweep, pack_sweep  # noqa: F401
