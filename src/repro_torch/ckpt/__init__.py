from repro_torch.ckpt.index_io import load_index, save_index

__all__ = ["load_index", "save_index"]
