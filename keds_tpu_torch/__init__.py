"""PyTorch/CUDA port of :mod:`keds_tpu` for NVIDIA Hopper (H100).

Module names mirror ``keds_tpu``'s so each function has an obvious
counterpart.  The package imports torch, numpy and the standard library
only; it never imports jax or ``keds_tpu``.  Entry points run on the CUDA
device unless the caller passes ``device="cpu"``.  The two TPU kernels
(fused MIPS top-k, fused attention) and the attention's backward are
hand-written CUDA C++ in ``csrc/``, built with ``nvcc`` at first use
(:mod:`.ops.cuda_build`); on a CPU tensor each wrapper runs its plain
PyTorch version instead.  It covers the composed-query serving path
(:mod:`.engine`) and features-mode training of the image stream
(:mod:`.train`, :mod:`.cli.main`).
"""
