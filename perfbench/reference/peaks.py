"""Published peaks of one NVIDIA H100 SXM5 80 GB, the denominators of
the roofline shares.

Source: NVIDIA H100 Tensor Core GPU data sheet (SXM5 column; dense
rates, without sparsity), at the card's full 700 W power limit. A card
set below that limit reaches less; the result line carries the card's
limit beside every run.
"""
HBM_BYTES_PER_S = 3.35e12      # HBM3, 80 GB
BF16_OPS_PER_S = 989e12        # tensor cores, dense bf16 / fp16
F32_OPS_PER_S = 67e12          # float32 outside the tensor cores
SOURCE = ("NVIDIA H100 Tensor Core GPU data sheet, SXM5: 3.35 TB/s HBM3, "
          "989 TFLOP/s dense bf16, 67 TFLOP/s float32")


def roofline_share(nbytes: float, ops: float, seconds: float,
                   ops_per_s: float = F32_OPS_PER_S) -> float:
    """Percent of the least time the chip could take for this work (the
    larger of bytes over bandwidth and operations over the peak rate)
    against the measured ``seconds``."""
    return 100.0 * max(nbytes / HBM_BYTES_PER_S, ops / ops_per_s) / seconds
