"""openslam_g2o_torch: the PyTorch/CUDA port of openslam_g2o_tpu.

This package imports torch and numpy and never jax. Ported are the SE2 and
SE3 pose-graph Levenberg-Marquardt with block-Jacobi-scaled PCG on the
block-sparse Hessian (3x3 and 6x6 blocks), the dense Gauss-Newton /
Levenberg-Marquardt route over every type of models/slam2d.py and
models/slam3d.py, and Schur-complement bundle adjustment (core/ba_ell.py,
the expmap types of models/sba.py and the BAL camera of models/bal.py,
read from a BAL file by `load_bal_problem`), from a .g2o file or a generator
(apps/simulator.py) to a converged chi2; the hot loops run as hand-written CUDA kernels on an NVIDIA
GPU (openslam_g2o_torch/kernels) and as their plain PyTorch versions on the
CPU.

    from openslam_g2o_torch import Graph, loads_g2o
    from openslam_g2o_torch.core.algorithms import LevenbergMarquardtPCG, optimize
    prob = loads_g2o(text).compile(dtype=torch.float32)
    result, stats = optimize(prob, LevenbergMarquardtPCG(), iterations=10)

`compile()`, `build_problem()` and the synthetic generator build on the card
by default (device=None means "cuda") and raise where there is no GPU; pass
device="cpu" to run the plain versions on the CPU.
"""
from openslam_g2o_torch.models import slam2d as _slam2d  # registers 2D types
from openslam_g2o_torch.models import slam3d as _slam3d  # registers 3D types
from openslam_g2o_torch.models import sba as _sba  # registers the BA types
from openslam_g2o_torch.models import bal as _bal  # the BAL camera and edge
from openslam_g2o_torch.core.graph import Graph
from openslam_g2o_torch.io.g2o_format import load_g2o, loads_g2o, save_g2o

__all__ = ["Graph", "load_g2o", "loads_g2o", "save_g2o"]
