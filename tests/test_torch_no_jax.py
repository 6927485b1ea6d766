"""The port imports no JAX: in a fresh interpreter, import openslam_g2o_torch
and run small CPU optimizations through the public API (LM-PCG on an SE2
and on an SE3 pose graph, the default dense LM and GN on a 2D and a 3D
landmark world, the Schur BA solver on a synthetic BAL problem on both of
its routes, the general Schur path on an anchored inverse-depth scene,
directly and through `_SchurAuto`), then check that
no jax module (nor the JAX package, which pulls jax in) was loaded. Every
module of the port and chip_smoke.py are imported, and no source file of
either names jax or the JAX package in an import statement."""
import os
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

SCRIPT = r"""
import sys
import torch
torch.set_num_threads(1)
import openslam_g2o_torch
from openslam_g2o_torch import loads_g2o
from openslam_g2o_torch.apps.simulator import (
    Simulator2D, Simulator3D, create_sphere, synthetic_pose_graph_2d)
from openslam_g2o_torch.core.algorithms import (
    GaussNewton, LevenbergMarquardtPCG, optimize)
import importlib, pkgutil
for mod in pkgutil.walk_packages(openslam_g2o_torch.__path__,
                                 "openslam_g2o_torch."):
    importlib.import_module(mod.name)         # every module of the port
for name in ("kernels.damp_chol", "kernels.jacobi_scale", "kernels.cg_step",
             "kernels.chebyshev", "kernels.gather", "kernels.build",
             "kernels.dense_assemble", "kernels.retract_chi2",
             "kernels.edge_se3", "models.slam3d", "ops.lie", "utils.np_lie",
             "kernels.ba_edge", "kernels.ba_inv", "kernels.ba_schur",
             "kernels.ba_coupling", "core.ba_ell", "models.sba", "models.bal",
             "core.ba", "core.factory", "kernels.schur_general",
             "apps.profile_window", "apps.simulator",
             "interop"):
    assert "openslam_g2o_torch." + name in sys.modules, name
import chip_smoke                             # imports nothing at top level

prob, _ = synthetic_pose_graph_2d(n_poses=200, grid=10, device="cpu")
_, stats = optimize(prob, LevenbergMarquardtPCG(pcg_iters=30, pcg_tol=1e-4),
                    iterations=3)
assert stats[-1]["chi2"] < stats[0]["chi2"] or stats[0]["ok"], stats
_, stats = optimize(prob, LevenbergMarquardtPCG(pcg_iters=30, pcg_tol=1e-4,
                                                pcg_cheby=3), iterations=2)
assert stats[-1]["ok"], stats
graph, _ = Simulator2D(n_landmarks=15, seed=0).simulate(30)
world = graph.compile(device="cpu")
_, stats = optimize(world, iterations=4)          # the dense LM default
assert stats[-1]["ok"] and "lambda" in stats[-1], stats
assert stats[-1]["chi2"] < stats[0]["chi2"], stats
_, stats = optimize(world, GaussNewton(), iterations=3)
assert stats[-1]["ok"], stats
sphere = create_sphere(n_laps=4, n_per_lap=12, radius=8.0,
                       seed=0)[0].compile(device="cpu")
_, stats = optimize(sphere, LevenbergMarquardtPCG(pcg_iters=30, pcg_tol=1e-4),
                    iterations=3)                 # SE3 poses, 6x6 blocks
assert stats[-1]["ok"] and stats[-1]["chi2"] < stats[0]["chi2"], stats
world3 = Simulator3D(n_landmarks=15, seed=0).simulate(15)[0].compile(
    device="cpu")
_, stats = optimize(world3, iterations=3)         # the dense route on 3D
assert stats[-1]["ok"], stats
from openslam_g2o_torch.apps.simulator import synthetic_bal_problem
from openslam_g2o_torch.core import ba_ell
bal, _ = synthetic_bal_problem(n_cams=8, n_points=60, device="cpu")
for max_tp in (1536, -1):                        # dense-Schur, implicit
    ba_ell._DENSE_SCHUR_MAX_TP = max_tp
    _, stats = optimize(bal, ba_ell.LevenbergMarquardtSchurELL(
        pcg_iters=20, pcg_tol=1e-4), iterations=3)
    assert stats[-1]["ok"] and stats[-1]["chi2"] < stats[0]["chi2"], stats
from openslam_g2o_torch.core.ba import LevenbergMarquardtSchur
from openslam_g2o_torch.core.factory import _SchurAuto
from openslam_g2o_torch.core.graph import Graph
import numpy as np
g = Graph()                               # the general Schur path: PSI2UV
g.add_parameter(0, "camera_parameters", [500.0, 0.0, 0.0, 0.1])
rng = np.random.default_rng(0)
for i in range(4):
    g.add_vertex(i, "se3_expmap", [-0.3 * i, 0, 0, 0, 0, 0, 1.0],
                 fixed=(i == 0))
for j in range(30):
    p = rng.uniform(-1, 1, 3) + [0.5, 0, 5.0]
    g.add_vertex(10 + j, "sba_point_xyz", [p[0] / p[2], p[1] / p[2],
                                          1.1 / p[2]], marginalized=True)
    for i in range(4):
        pc = p + [-0.3 * i, 0, 0]
        g.add_edge("edge_project_psi2uv", (10 + j, i, 0),
                   500 * pc[:2] / pc[2] + rng.normal(0, 0.5, 2), np.eye(2),
                   param_ids=[0])
anchored = g.compile(device="cpu")
for alg in (LevenbergMarquardtSchur(pcg_iters=40), _SchurAuto()):
    _, stats = optimize(anchored, alg, iterations=3)
    assert stats[-1]["ok"] and stats[-1]["chi2"] < stats[0]["chi2"], stats
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib",
                                            "openslam_g2o_tpu")))
assert not bad, bad
print("NO_JAX_OK")
"""


def test_port_sources_name_no_jax_import():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|openslam_g2o_tpu)\b",
                         re.M)
    files = sorted((REPO / "openslam_g2o_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 20
    bad = [str(f.relative_to(REPO)) for f in files
           if pattern.search(f.read_text())]
    assert not bad, bad


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=str(REPO),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "NO_JAX_OK" in proc.stdout
