"""PyTorch + CUDA port of the dense monocular SLAM system.

The JAX package ``mast3r_slam_tpu`` is the reference; every module here
mirrors its counterpart there (same module names, same public layouts) and
is tested against it on the CPU.  On an NVIDIA card the three TPU kernels
run as hand-written CUDA (``csrc/``): attention (``ops/attention.py``), the
Gauss-Newton accumulation and solve (``ops/gn.py``) and the matcher's
packed probe tables (``ops/pack.py``).
"""
