"""Models of the port: the decoder-only LM family (``transformer``), the
GNN family (``gnn``) and the recsys family (``recsys``)."""
