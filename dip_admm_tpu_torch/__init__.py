"""dip_admm_tpu_torch — the PyTorch/CUDA port of ``dip_admm_tpu``.

Decentralized edge-consensus ADMM for TV-regularized least-squares CT
reconstruction, written in PyTorch for one NVIDIA Hopper GPU. The module
names mirror the JAX package so each counterpart is easy to find:

- ``ops``     : phantoms, angle split, TV operators, the ``fft_skew``,
                ``fft_shear``, ``fft_grouped``, ``fft_pallas`` and
                ``fft_mxu`` projectors (``radon_fft``), fan beam by
                rebinning (``radon_fan``) and the hand-written CUDA kernels
                (``ops/kernels/*.py`` + ``csrc/*.cu``).
- ``graph``   : precision weights Q and per-pixel knn graphs.
- ``data``    : problem construction and loading the JAX problem bundle.
- ``core``    : the Condat-Vu node solver and the consensus loop.
- ``runners`` : the command-line entry point.

Importing the package imports neither JAX nor Triton and builds nothing:
the CUDA kernels compile at their first launch.
"""

__version__ = "0.1.0"

from dip_admm_tpu_torch.config import (  # noqa: F401
    AdmmConfig,
    GeometryConfig,
    GraphConfig,
    NodeSolverConfig,
    ProblemConfig,
)
