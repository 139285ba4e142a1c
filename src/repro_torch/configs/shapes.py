"""Assigned input shapes per family (the JAX package's table, verbatim for
the families the port serves so far)."""

LM_SHAPES = {
    "train_4k":    dict(kind="train",   seq_len=4096,   global_batch=256),
    "prefill_32k": dict(kind="prefill", seq_len=32768,  global_batch=32),
    "decode_32k":  dict(kind="decode",  seq_len=32768,  global_batch=128),
    "long_500k":   dict(kind="decode",  seq_len=524288, global_batch=1),
}

RECSYS_SHAPES = {
    "train_batch":    dict(kind="train",     batch=65_536),
    "serve_p99":      dict(kind="serve",     batch=512),
    "serve_bulk":     dict(kind="serve",     batch=262_144),
    "retrieval_cand": dict(kind="retrieval", batch=1, n_candidates=1_000_000),
}

SHAPE_PARAMS = {"lm": LM_SHAPES, "recsys": RECSYS_SHAPES}
