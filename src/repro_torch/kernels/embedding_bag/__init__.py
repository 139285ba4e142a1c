from .ops import BagSum, bag_sum, bag_sum_backward  # noqa: F401
from .ref import (backward_plan, bag_sum_backward_ref,  # noqa: F401
                  bag_sum_ref, take_fill)
