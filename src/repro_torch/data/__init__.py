"""Data pipelines of the port's training cells: the JAX package's LM
token stream, recsys stream, graph builders and neighbour sampler (numpy
copies; the graph builders upload to the caller's device)."""
from .graphs import (bucket_edges_by_dst, make_graph_batch,  # noqa: F401
                     synth_feature_graph, synth_molecule_batch)
from .lm import TokenStream  # noqa: F401
from .recsys import RecsysStream  # noqa: F401
from .sampler import NeighborSampler, csr_from_edges  # noqa: F401
