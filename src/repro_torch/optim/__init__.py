"""Optimizer of the port: AdamW with global-norm clipping, the
learning-rate schedules, and gradient compression for data-parallel
means (int8 with stochastic rounding, top-k with error feedback; a
process group's mean through ``torch.distributed``, or one rank's)."""
from .adamw import (OptState, adamw_init, adamw_update,  # noqa: F401
                    clip_by_global_norm, global_norm)
from .compress import (ErrorFeedback, compressed_mean,  # noqa: F401
                       dequantize_int8, quantize_int8, topk_sparsify,
                       uniform_noise, wire_bytes)
from .schedules import cosine_schedule, linear_warmup  # noqa: F401
