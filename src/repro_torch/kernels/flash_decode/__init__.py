from .ops import flash_decode  # noqa: F401
from .ref import flash_decode_ref, q_scale  # noqa: F401
