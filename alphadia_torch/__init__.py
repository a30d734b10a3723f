"""alphadia-torch: the DIA extraction path in PyTorch with CUDA kernels.

The counterpart of the JAX package for NVIDIA Hopper cards. Module names
mirror the JAX package so each function has an obvious counterpart. The
package imports torch and numpy only; the one hand-written kernel
(``csrc/xic.cu``) is compiled with nvcc at first use.

Frames are column dicts (``dict[str, np.ndarray]``) with the column names
and dtypes of the JAX package's pandas frames.
"""

__version__ = "0.1.0"
