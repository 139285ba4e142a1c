from .ops import bag_sum  # noqa: F401
from .ref import bag_sum_ref, take_fill  # noqa: F401
