"""Assigned input shapes per family (the JAX package's table, verbatim)."""

LM_SHAPES = {
    "train_4k":    dict(kind="train",   seq_len=4096,   global_batch=256),
    "prefill_32k": dict(kind="prefill", seq_len=32768,  global_batch=32),
    "decode_32k":  dict(kind="decode",  seq_len=32768,  global_batch=128),
    "long_500k":   dict(kind="decode",  seq_len=524288, global_batch=1),
}

GNN_SHAPES = {
    "full_graph_sm": dict(kind="train", n_nodes=2708, n_edges=10556,
                          d_feat=1433, n_classes=7),
    "minibatch_lg":  dict(kind="train", n_nodes=232_965,
                          n_edges=114_615_892, batch_nodes=1024,
                          fanout=(15, 10), d_feat=602, n_classes=41),
    "ogb_products":  dict(kind="train", n_nodes=2_449_029,
                          n_edges=61_859_140, d_feat=100, n_classes=47),
    "molecule":      dict(kind="train", n_nodes=30, n_edges=64, batch=128,
                          n_classes=2),
}

RECSYS_SHAPES = {
    "train_batch":    dict(kind="train",     batch=65_536),
    "serve_p99":      dict(kind="serve",     batch=512),
    "serve_bulk":     dict(kind="serve",     batch=262_144),
    "retrieval_cand": dict(kind="retrieval", batch=1, n_candidates=1_000_000),
}

FAMILY_SHAPES = {
    "lm": list(LM_SHAPES),
    "gnn": list(GNN_SHAPES),
    "recsys": list(RECSYS_SHAPES),
}

SHAPE_PARAMS = {"lm": LM_SHAPES, "gnn": GNN_SHAPES, "recsys": RECSYS_SHAPES}
