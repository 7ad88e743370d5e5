"""PyTorch/CUDA port of the odh_kubeflow_tpu workload library.

A package of its own beside ``odh_kubeflow_tpu``: it imports torch and
numpy, never jax and nothing of the JAX package. The layout mirrors the JAX
package's (``ops/``, ``models/``, ``serving/``, ``probe/``; ``device.py`` and
``telemetry.py`` for ``tpu/detect.py`` and ``tpu/telemetry.py``) so each
module's counterpart is found by name. Entry points run on the card
(``device="cuda"``) unless the caller names the CPU; the TPU kernels of the
serving and training paths are CUDA C++ kernels for sm_90a
(``ops/csrc/flash_fwd.cu``, ``ops/csrc/flash_bwd.cu``).
"""
