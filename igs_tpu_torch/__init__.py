"""igs_tpu_torch — the PyTorch/CUDA port of igs_tpu for NVIDIA Hopper.

A second package beside ``igs_tpu`` (the JAX reference, which it never
imports). Module names follow the reference so each module's counterpart
is easy to find: ``core/``, ``ops/``, ``models/``, ``stream/``,
``builders.py``. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; the one hand-written kernel of this slice (the packed
forward blend, ``csrc/blend_fwd.cu``) is built with ``nvcc`` at first use.
"""

__version__ = "0.1.0"
