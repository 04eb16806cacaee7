"""floxer-tpu on PyTorch and CUDA: the verification path of the aligner
with hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

The JAX package `floxer_tpu` is the reference. This package imports
nothing of it: it carries its own copies of the reference's jax-free host
modules (CLI, IO, FM index, search, PEX trees, the native C++ library,
SAM/BAM writers; each copy names its original in its first line) and its
own device layer. It never imports jax.
"""

# the reference's program metadata (floxer_tpu/__init__.py), which the CLI
# reports
__version__ = "0.1.0"

PROGRAM_NAME = "floxer-tpu"
