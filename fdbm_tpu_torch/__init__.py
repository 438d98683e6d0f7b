"""fdbm_tpu_torch: the PyTorch + CUDA port of fdbm_tpu for one NVIDIA H100.

It serves single files (``infer_single``) and folders in batches
(``infer_folder``), trains (``train``) the generative and predictive
TF-GridNets and NCSN++ U-Nets in fp32 or bf16, fine-tunes the enhanced
bridge (``train_finetuning``) and scores enhanced audio (``evaluate``). It
mirrors the JAX package's module names (``dsp``, ``paths``, ``sampling``,
``model``, ``models.tfgridnet``, ``models.ncsnpp``, ``ops.gridrnn``, ...)
and imports nothing of it. Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``; on CPU tensors every kernel wrapper runs its plain
PyTorch version. The CUDA kernels are built with nvcc, and the data
loader's native WAV decoder (``native/wavio.cc``) with g++, at first use.
"""

__version__ = "0.1.0"
