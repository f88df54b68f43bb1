from repro_torch.ckpt.index_io import load_index

__all__ = ["load_index"]
