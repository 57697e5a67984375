"""Model substrate of the port: the decoder-only transformer (dense, GQA,
sliding-window attention), DLRM, and their building blocks."""
