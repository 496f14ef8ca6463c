"""PyTorch/CUDA port of the DSAG reproduction (``repro`` is the JAX reference).

The port keeps the JAX package's module layout.  It imports ``torch`` and
numpy only, never ``jax`` or ``repro``: whatever it needs from a numpy module
of the reference is copied.  Entry points run on the card by default
(``EngineConfig(device="cuda", kernel_backend="cuda")``); tests ask for the
CPU and the plain-torch kernel versions explicitly.
"""

import torch

# float32 products on the card run in full float32: the PCA suboptimality
# and projection and the plain kernel versions use torch.matmul, and the
# parity tolerances are stated for IEEE float32, not TF32
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
