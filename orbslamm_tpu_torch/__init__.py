"""orbslamm_tpu_torch — the PyTorch/CUDA port of orbslamm_tpu.

The JAX package ``orbslamm_tpu`` is the reference this package is held
against; the layout mirrors it path for path (``orbslamm_tpu/ops/orb.py`` ↔
``orbslamm_tpu_torch/ops/orb.py``). Plain tensor code is PyTorch; the one
Pallas TPU kernel of the JAX package (the fused masked Hamming matcher) is a
hand-written CUDA kernel for Hopper, ``csrc/hamming.cu``, bound with ctypes
in ``ops/cuda/hamming.py``.

This package never imports jax. It reuses the numpy-only modules of the JAX
package: ``orbslamm_tpu.utils.config``, ``orbslamm_tpu.io.synthetic`` and
``orbslamm_tpu.eval.ate``.

The caller always names the device (``empty_map``, ``make_extractor`` and
``MonocularSession`` take ``device``); nothing here picks one silently.

Precision is pinned here, at import: float32 everywhere, and TF32 off for
both matrix products and cuDNN, so that results on the card stay float32
like the reference's.
"""

import torch

torch.set_default_dtype(torch.float32)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
