from .manager import (CheckpointManager, LeafSpec, load_pytree,  # noqa: F401
                      save_pytree)
