"""brisk_tpu_torch: the brisk k-mer engine on PyTorch + CUDA.

A port of the JAX package `brisk_tpu` (kept beside it as the reference)
to plain PyTorch tensor code, with the one Pallas kernel of the main path
(the finalize span expansion) rewritten as a CUDA C++ kernel for Hopper
(`csrc/expand_span.cu`, bound in `kernels.py`). Module paths and function
names mirror `brisk_tpu`, so each counterpart sits at the same path.

Conventions:
  * a u32 value under arithmetic is held in int64 (torch has no uint32
    arithmetic); every add, shift, multiply and not is masked back to 32
    bits (`_u32`);
  * arena columns and kernel inputs/outputs are int32 tensors holding the
    u32 bit pattern (4 B/word, like the JAX arena); numpy sees them
    through `.view(np.uint32)`;
  * every state constructor and `Brisk` take an explicit `device`.

Importing the package does no device work and never imports jax.
"""

from brisk_tpu_torch.params import Parameters

__all__ = ["Parameters"]
__version__ = "0.1.0"
