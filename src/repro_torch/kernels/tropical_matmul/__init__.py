from .ops import minplus  # noqa: F401
from .ref import minplus_ref  # noqa: F401
