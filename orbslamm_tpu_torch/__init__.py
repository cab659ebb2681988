"""orbslamm_tpu_torch — the PyTorch/CUDA port of orbslamm_tpu.

The JAX package ``orbslamm_tpu`` is the reference this package is held
against; the layout mirrors it path for path (``orbslamm_tpu/ops/orb.py`` ↔
``orbslamm_tpu_torch/ops/orb.py``). Plain tensor code is PyTorch; the one
Pallas TPU kernel of the JAX package (the fused masked Hamming matcher) is a
hand-written CUDA kernel for Hopper, ``csrc/hamming.cu``, bound with ctypes
in ``ops/cuda/hamming.py``.

This package imports neither jax nor any module of the JAX package. It
keeps its own copies of the JAX package's numpy-only modules:
``utils/config.py``, ``io/synthetic.py`` (with a ``fabricate_map`` that builds
this package's ``MapState``), ``io/trajectory.py``, ``io/datasets.py`` and
``eval/ate.py``; ``tests/test_torch_package.py`` and ``tests/test_torch_io.py``
hold them equal to the originals. Map, session and trajectory files are
the same in both packages: each reads the other's.

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
