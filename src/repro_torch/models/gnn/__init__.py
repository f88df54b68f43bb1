"""The GNN family: GIN (``gin``) and the host-side fanout sampler
(``sampler``)."""
