"""PyTorch / CUDA port of the SMIN video moment localizer.

A second implementation beside ``video_moment_localization_tpu`` (the JAX
reference, which this package never imports). Module names mirror the JAX
package. Kernels are hand-written CUDA C++ for Hopper (``csrc/``), built
with nvcc at first use; on CPU tensors every kernel wrapper runs its plain
PyTorch version.
"""
