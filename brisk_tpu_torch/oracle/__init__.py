from brisk_tpu_torch.oracle import pyref

__all__ = ["pyref"]
