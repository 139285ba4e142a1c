from .ops import relax_level_  # noqa: F401
from .ref import relax_bucketed_ref, relax_level_ref_  # noqa: F401
