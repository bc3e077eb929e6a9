"""Models of the LM, recsys and GNN substrate (port of `repro/models`): the
decoder-only LM, dense and MoE (`lm`), the Behavior Sequence Transformer
(`bst`) and the GNNs (`gnn`: GAT, SchNet, MeshGraphNet, DimeNet)."""
