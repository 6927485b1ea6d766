"""The linearizers' contribution streams padded to whole 128-byte lines
(core/sparse.py `stream_columns`, `EllPattern.e_cols`).

Every block of the streams is e_total rounded up to a multiple of
STREAM_ALIGN columns wide, so that on the card a warp's 32 stores of one
row fill whole lines. Here the padded pattern references no padding column,
and kernel C's plain version assembles from the padded streams exactly what
it assembles from the same streams with the padding cut out (the same
additions in the same order).
"""
import numpy as np
import pytest
import torch

from openslam_g2o_torch.apps.simulator import (
    create_sphere, synthetic_pose_graph_2d)
from openslam_g2o_torch.core import sparse
from openslam_g2o_torch.kernels.assemble import assemble_gather_plain

torch.set_num_threads(1)


@pytest.mark.parametrize("e_total", [0, 1, 31, 32, 33, 149963])
def test_stream_columns(e_total):
    cols = sparse.stream_columns(e_total)
    assert cols % sparse.STREAM_ALIGN == 0
    assert e_total <= cols < e_total + sparse.STREAM_ALIGN


def _problem(kind):
    if kind == "se2":
        prob, _ = synthetic_pose_graph_2d(n_poses=300, grid=10,
                                          dtype=torch.float64, device="cpu")
        return prob
    g, _ = create_sphere(n_laps=6, n_per_lap=25, radius=8.0,
                         trans_noise=(0.03, 0.03, 0.03), rot_noise=0.002,
                         seed=3)
    for e in g.edges[::4]:
        e.kernel, e.kernel_delta = "Huber", 0.5      # a second edge group
    return g.compile(dtype=torch.float64, device="cpu")


def _cut(stream, blocks, W, E):
    """The stream with each block's padding columns cut out."""
    return stream.view(stream.shape[0], blocks, W)[:, :, :E] \
        .reshape(stream.shape[0], blocks * E)


@pytest.mark.parametrize("kind", ["se2", "se3"])
def test_padded_streams_assemble_the_same_system(kind):
    prob = _problem(kind)
    pattern = sparse.build_ell_pattern(prob)
    E, W, D = pattern.e_total, pattern.e_cols, pattern.d
    assert W == sparse.stream_columns(E) and W > E
    cut_tables = []
    for tbl, blocks in ((pattern.hidx, 4), (pattern.bidx, 2)):
        cols = tbl[tbl >= 0].numpy()
        assert cols.max() < blocks * W
        assert (cols % W < E).all()              # no padding column
        assert len(np.unique(cols)) == blocks * E
        cut_tables.append(torch.where(tbl >= 0, tbl // W * E + tbl % W, tbl))
    hblk, bblk = sparse.edge_blocks(prob, pattern)
    assert hblk.shape == (D * D, 4 * W) and bblk.shape == (D, 2 * W)
    values, b = sparse.assemble_ell(prob, pattern)
    values0, b0 = assemble_gather_plain(
        _cut(hblk, 4, W, E), _cut(bblk, 2, W, E), *cut_tables,
        pattern.k, pattern.n)
    assert torch.equal(values, values0)
    assert torch.equal(b[pattern.group], b0)
