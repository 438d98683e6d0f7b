"""fdbm_tpu_torch: the PyTorch + CUDA port of fdbm_tpu for one NVIDIA H100.

It serves (``infer_single``) and trains (``train``) the generative
TF-GridNet. It mirrors the JAX package's module names (``dsp``, ``paths``,
``sampling``, ``model``, ``models.tfgridnet``, ``ops.gridrnn``, ...) and
imports nothing of it. Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``; on CPU tensors every kernel wrapper runs its plain
PyTorch version. The CUDA kernels are built with nvcc at first use.
"""

__version__ = "0.1.0"
