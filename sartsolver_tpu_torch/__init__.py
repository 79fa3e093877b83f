"""sartsolver_tpu_torch — the constrained SART solver in PyTorch and CUDA.

The one-device ``sartsolve`` path of the JAX package ``sartsolver_tpu``
(which stays the reference) for an NVIDIA Hopper card: HDF5 ingest, the
linear and logarithmic constrained SART solvers with the Laplacian penalty,
and the solution file. The loop's sweep is a hand-written CUDA kernel
(``ops/csrc/fused_sweep.cu``), built with ``nvcc`` on first use.

Importing the package imports ``torch`` and ``numpy`` only: HDF5 files go
through the package's own reader and writer (``io/h5.py``), since the card's
host has no HDF5 library. It imports neither JAX nor any module of
``sartsolver_tpu``.
"""

__version__ = "0.1.0"
