"""PyTorch/CUDA port of FusionOcc for one NVIDIA H100.

Mirrors the layout of ``fusionocc_tpu``; hand-written CUDA kernels live in
``csrc/`` and are built on first use by ``ops/kernels.py``.
"""
