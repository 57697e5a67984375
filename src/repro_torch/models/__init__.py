"""Model substrate of the port: the decoder-only transformer (dense, GQA,
sliding-window attention), DLRM, the GNN zoo (EGNN, MeshGraphNet, SchNet,
GraphSAGE), and their building blocks."""
