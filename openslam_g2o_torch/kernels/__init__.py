"""Hand-written CUDA kernels of the LM-PCG main path, with their wrappers.

Each wrapper takes torch tensors. On CPU tensors it runs the kernel's plain
PyTorch version, which sits beside it in the same module; on CUDA tensors it
launches the kernel (built from kernels/csrc on first use, kernels/build.py)
or raises. There is no fallback between the two and no switch: the device
of the arguments decides. Every wrapper counts its kernel launches in a
plain integer attribute, `wrapper.launches`.

    A  spmv.block_ell_spmv       block-ELL SpMV            (ROADMAP K5)
    B  edge_se2.edge_se2_blocks  fused SE2 linearizer      (ROADMAP K1)
    C  assemble.assemble_gather  contributor-gather H, b   (ROADMAP K2)
"""
from __future__ import annotations

from openslam_g2o_torch.kernels.assemble import assemble_gather
from openslam_g2o_torch.kernels.edge_se2 import edge_se2_blocks
from openslam_g2o_torch.kernels.spmv import block_ell_spmv

WRAPPERS = (block_ell_spmv, edge_se2_blocks, assemble_gather)


def launch_counts() -> dict:
    """{wrapper name: launches so far}."""
    return {w.__name__: w.launches for w in WRAPPERS}


def reset_launch_counts():
    for w in WRAPPERS:
        w.launches = 0
