"""Models the port serves and trains: the decoder-only LMs (dense GQA,
gemma3's sliding window, top-k MoE) through the ``flash_decode`` kernel,
DLRM (rm2) through the ``bag_sum`` kernel, and the GNN family."""
