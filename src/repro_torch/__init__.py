"""The PyTorch/CUDA port of the ``repro`` triangular-solve serving stack.

Imports ``torch`` and never ``jax`` or ``repro``; ``repro_torch.api``
is the front door.  Its layout mirrors ``repro`` module for module.
"""
