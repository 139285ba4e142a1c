"""GNN family of the port: GCN, GIN, SchNet, EquiformerV2 (eSCN).

All message passing is a gather by edge endpoint (``index_select``) and a
scatter-add by destination (``index_add``) over the edge list, as the
JAX package builds it on ``jnp.take`` and segment sums.  Edge arrays are
padded with a sentinel node (id == n_nodes): gathers read an appended
fill row for it and scatters write a scrap row that is sliced off.
"""
from . import equiformer_v2, gcn, gin, schnet  # noqa: F401
from .common import GraphBatch, gather_scatter_sum, segment_softmax  # noqa: F401

#: arch id -> its model module (``init_params``, ``forward``, ``loss_fn``)
MODULES = {"gcn-cora": gcn, "gin-tu": gin, "schnet": schnet,
           "equiformer-v2": equiformer_v2}
