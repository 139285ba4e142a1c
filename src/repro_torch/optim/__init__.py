"""Optimizer of the port: AdamW with global-norm clipping and the
learning-rate schedules.  The JAX package's ``optim/compress.py``
(gradient compression for collectives) comes with the distributed slice
(``ROADMAP.md`` queue 1)."""
from .adamw import (OptState, adamw_init, adamw_update,  # noqa: F401
                    clip_by_global_norm, global_norm)
from .schedules import cosine_schedule, linear_warmup  # noqa: F401
