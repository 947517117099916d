"""garlic_tpu_torch: the PyTorch/CUDA port of garlic_tpu.

The pinned-cutoff Phase I-III path runs on an NVIDIA GPU: the two Phase-I
kernels are hand-written CUDA C++ (csrc/lod_windows.cu), the code around
them is plain PyTorch, and the host code (CLI, parsers, panel cache, the
native C++ runtime, the f64 exact engine) is shared with garlic_tpu.
Nothing here imports JAX; host modules of garlic_tpu that reach JAX at
import time are carried as copies (each names its source).
"""

from garlic_tpu.version import OUTPUT_COMPAT_VERSION, __version__

__all__ = ["__version__", "OUTPUT_COMPAT_VERSION"]
