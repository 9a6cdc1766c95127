"""igs_tpu_torch — the PyTorch/CUDA port of igs_tpu for NVIDIA Hopper.

A second package beside ``igs_tpu`` (the JAX reference, which it never
imports). Module names follow the reference so each module's counterpart
is easy to find: ``core/``, ``ops/``, ``models/``, ``stream/``,
``train/``, ``data/``, ``builders.py``, ``config.py``, the entry
points ``build_frame0.py`` and ``train_agm.py``, and the measurement
programs ``bench.py``, ``roofline.py``, ``profile_stages.py`` and
``tools/`` (timed by ``utils/devtime.py``). Entry points run on
``cuda`` unless the caller passes ``device="cpu"``; the hand-written
kernels (``csrc/*.cu``) are built with ``nvcc`` at first use.
"""

__version__ = "0.1.0"
