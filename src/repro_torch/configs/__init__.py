from repro_torch.configs.base import (ARCH_REGISTRY, ShapeCell,
                                      TransformerConfig, get_arch,
                                      list_archs, lm_shapes)

__all__ = ["ARCH_REGISTRY", "ShapeCell", "TransformerConfig", "get_arch",
           "list_archs", "lm_shapes"]
