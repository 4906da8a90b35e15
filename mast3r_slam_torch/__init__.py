"""PyTorch + CUDA port of the dense monocular SLAM tracking frontend.

The JAX package ``mast3r_slam_tpu`` is the reference; every module here
mirrors its counterpart there (same module names, same public layouts) and
is tested against it on the CPU.  On an NVIDIA card the two TPU kernels of
the tracking path run as hand-written CUDA (``csrc/``): attention
(``ops/attention.py``) and the Gauss-Newton accumulation (``ops/gn.py``).
"""
