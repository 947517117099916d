"""garlic_tpu_torch: the PyTorch/CUDA port of garlic_tpu.

The ROH-calling pipeline runs on an NVIDIA GPU: the four Phase-I kernels
are hand-written CUDA C++ (csrc/lod_windows.cu), the code around them is
plain PyTorch, and the host code (CLI, parsers, panel cache, the native
C++ runtime, the f64 exact engine) is the port's own copy of garlic_tpu's,
each copied function naming its source line.  The package imports
nothing of garlic_tpu and nothing of JAX.
"""

from .version import OUTPUT_COMPAT_VERSION, __version__

__all__ = ["__version__", "OUTPUT_COMPAT_VERSION"]
