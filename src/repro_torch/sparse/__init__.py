from repro_torch.sparse.ops import (PaddedSparse, alpha_mass_subvector,
                                    densify, sparsify, top_cut, top_k)
from repro_torch.sparse.quant import (dequantize_u8, quantize_u8,
                                      quantize_u8_ceil)

__all__ = ["PaddedSparse", "alpha_mass_subvector", "densify", "sparsify",
           "top_cut", "top_k", "quantize_u8", "quantize_u8_ceil",
           "dequantize_u8"]
