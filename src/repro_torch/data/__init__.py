"""Data pipelines of the port's training cells: the JAX package's LM
token stream and recsys stream (numpy copies).  The graph generators and
neighbour sampler come with the GNN family (``ROADMAP.md`` queue 1)."""
from .lm import TokenStream  # noqa: F401
from .recsys import RecsysStream  # noqa: F401
