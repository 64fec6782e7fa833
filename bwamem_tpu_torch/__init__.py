"""bwamem_tpu_torch — the BWA-MEM short-read aligner in PyTorch and CUDA.

The PyTorch port of bwamem_tpu for NVIDIA Hopper GPUs: the same module
layout (config, io, index, ops, pipeline, native, utils), plain tensor
functions with an explicit device, and the extension kernel written by hand
in CUDA C++ (csrc/).  It imports neither JAX nor bwamem_tpu.

Entry points (pipeline.align.Aligner, cli.main) run on "cuda" unless the
caller passes another device, and raise when no GPU is present.
"""
__version__ = "0.1.0"

from bwamem_tpu_torch.config import MemOptions  # noqa: E402,F401
