from repro_torch.kernels.flash_attention.ops import (attention_ref,
                                                     flash_attention,
                                                     flash_attention_ref)

__all__ = ["attention_ref", "flash_attention", "flash_attention_ref"]
