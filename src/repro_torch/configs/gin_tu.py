"""gin-tu [arXiv:1810.00826]: 5 layers, d_hidden=64, sum aggregator,
learnable eps (GIN-eps)."""
from repro_torch.configs.base import GNNConfig, GNN_SHAPES

CONFIG = GNNConfig(name="gin-tu", n_layers=5, d_hidden=64,
                   aggregator="sum", learn_eps=True)

SHAPES = GNN_SHAPES

REDUCED = GNNConfig(name="gin-tu-reduced", n_layers=3, d_hidden=16,
                    aggregator="sum", learn_eps=True, n_classes=4)
