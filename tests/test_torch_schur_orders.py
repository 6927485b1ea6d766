"""K14's host-built write orders (kernels/schur_general.py `edge_orders`,
built by core/ba.py `build_schur_pattern` for every W entry list): each is a
permutation of the entries, the landmark-major one keeps every tile of
EDGE_TILE entries in its tile and sorts it by slot, the pose-major one
sorts every entry by CSR position, and writing W_e by them, as the kernel
does, reproduces `schur_edge_blocks_plain`; `edge_orders` itself on seeded
positions at tile edges. On the CPU, on the general
Schur path's scenes: binary XYZ2UV, the anchored PSI2UV (two W entries an
edge in one pose group) and P2MC_INTRINSICS (two pose groups, a hub), with
12 and with 100 cameras."""

import numpy as np
import pytest
import torch

import chip_smoke
from openslam_g2o_torch.apps.simulator import synthetic_bal_problem
from openslam_g2o_torch.core import ba
from openslam_g2o_torch.core import problem as problem_mod
from openslam_g2o_torch.core.graph import Graph
from openslam_g2o_torch.kernels import schur_general

torch.set_num_threads(1)
TILE = schur_general.EDGE_TILE


# (cameras, points): with 12 cameras a tile of 128 edges (16 points) holds
# runs of each camera's CSR list, with 100 short ones
SIZES = {"12 cameras": (12, 400), "100 cameras": (100, 2000)}


def _scene(kind, size="12 cameras", dtype=torch.float64):
    C, P = SIZES[size]
    if kind == "xyz2uv":
        return synthetic_bal_problem(C, P, 8, dtype=dtype, device="cpu")[0]
    geo = chip_smoke.bal_geometry(C, P)
    build = {"psi2uv": chip_smoke.psi2uv_graph,
             "intrinsics": chip_smoke.p2mc_intrinsics_graph}[kind]
    return build(Graph, geo).compile(dtype=dtype, device="cpu")


KINDS = ["xyz2uv", "psi2uv", "intrinsics"]


@pytest.mark.parametrize("size", list(SIZES))
@pytest.mark.parametrize("kind", KINDS)
def test_orders_are_permutations_in_destination_order(kind, size):
    pat = ba.build_schur_pattern(_scene(kind, size))
    assert pat.cross
    for ce in pat.cross:
        lm_pos, pose_pos = ce.lm_pos.numpy(), ce.pose_pos.numpy()
        lm_order, pose_order = ce.lm_order.numpy(), ce.pose_order.numpy()
        E = len(lm_pos)
        for order in (lm_order, pose_order):
            assert order.dtype == np.int32 and order.shape == (E,)
            assert np.array_equal(np.sort(order), np.arange(E))
        # landmark-major: tile by tile, each tile's entries by slot
        assert np.array_equal(lm_order // TILE, np.arange(E) // TILE)
        for t0 in range(0, E, TILE):
            assert np.all(np.diff(lm_pos[lm_order[t0:t0 + TILE]]) > 0)
        # pose-major: every entry by CSR position
        assert np.all(np.diff(pose_pos[pose_order]) > 0)


@pytest.mark.parametrize("E", [1, TILE - 1, TILE + 1, 1000])
@pytest.mark.parametrize("runs", [False, True])
def test_edge_orders_at_tile_edges(E, runs):
    """`edge_orders` on seeded positions around a tile of EDGE_TILE
    edges, pose positions scattered or in runs of 8 consecutive ones (an
    anchor slot's): lm_order keeps each tile's edges in their tile sorted
    by slot, pose_order is the inverse of the pose positions' ranks."""
    rng = np.random.default_rng(E)
    lm_pos = rng.permutation(3 * E)[:E]
    pose_pos = (rng.permutation(100 * E)[:E] if not runs else
                8 * 3 * rng.permutation(E // 8 + 1)[np.arange(E) // 8]
                + np.arange(E) % 8)
    lm_order, pose_order = schur_general.edge_orders(lm_pos, pose_pos)
    for order in (lm_order, pose_order):
        assert np.array_equal(np.sort(order), np.arange(E))
    want = np.concatenate([t0 + np.argsort(lm_pos[t0:t0 + TILE])
                           for t0 in range(0, E, TILE)])
    assert np.array_equal(lm_order, want)
    rank = np.empty(E, dtype=np.int64)
    rank[pose_order] = np.arange(E)
    assert np.array_equal(rank, np.argsort(np.argsort(pose_pos)))


@pytest.mark.parametrize("size", list(SIZES))
@pytest.mark.parametrize("kind", KINDS)
def test_writing_by_the_orders_reproduces_the_plain_version(kind, size):
    """Every (edge group, pose slot) of the scene: W_e of every entry
    (the plain version's products), written as the kernel writes them,
    the landmark-major table tile by tile through lm_order and the
    pose-major one position by position through pose_order, gives the
    plain version's tables."""
    prob = _scene(kind, size)
    pat = ba.build_schur_pattern(prob)
    lin = problem_mod.linearize(prob)
    dl = pat.dl
    W_lm = {pg.name: torch.zeros((pg.dim * dl,) + tuple(pg.lm_pose.shape),
                                 dtype=prob.dtype)
            for pg in pat.pose_groups}
    W_pose = {pg.name: torch.zeros((pg.dim * dl, pg.n_entries),
                                   dtype=prob.dtype)
              for pg in pat.pose_groups}
    want_lm = {k: v.clone() for k, v in W_lm.items()}
    want_pose = {k: v.clone() for k, v in W_pose.items()}
    for le in pat.lm_edges:
        resid, jacs, rho1 = lin[le.egkey]
        info = prob.edges[le.egkey].information
        jl = jacs[le.lm_slot]
        for ce in (c for c in pat.cross if c.egkey == le.egkey):
            jp = jacs[ce.slot]
            schur_general.schur_edge_blocks_plain(
                resid, jl, jp, rho1, info, None, None, le.offset,
                want_lm[ce.group], ce.lm_pos, want_pose[ce.group],
                ce.pose_pos)
            # W_e [E, Dp*dl], as the plain version forms it
            w_om = rho1[:, None, None] * info
            jp_w = (jp[:, :, :, None] * w_om[:, :, None, :]).sum(dim=1)
            W = (jp_w[:, :, :, None] * jl[:, None]).sum(dim=2).reshape(
                len(rho1), -1)
            E = W.shape[0]
            flat = W_lm[ce.group].view(W.shape[1], -1)
            lm_order = ce.lm_order.long()
            for t0 in range(0, E, TILE):       # a tile kernel's block
                for j in range(t0, min(t0 + TILE, E)):
                    e = int(lm_order[j])
                    flat[:, int(ce.lm_pos[e])] = W[e]
            dest = W_pose[ce.group]          # in CSR order
            for e in ce.pose_order.long().tolist():
                dest[:, int(ce.pose_pos[e])] = W[e]
    for k in W_lm:
        assert torch.equal(W_lm[k], want_lm[k])
        assert torch.equal(W_pose[k], want_pose[k])


def test_plain_version_takes_the_wrappers_arguments():
    """chip_smoke.py's plain route swaps the wrapper for its plain version
    under core/ba.py `schur_build`, which passes the pattern's orders: the
    two take the same arguments, and the plain version ignores the
    orders."""
    import inspect
    assert (list(inspect.signature(schur_general.schur_edge_blocks).parameters)
            == list(inspect.signature(
                schur_general.schur_edge_blocks_plain).parameters))
    prob = _scene("psi2uv")
    pat = ba.build_schur_pattern(prob)
    real = schur_general.schur_edge_blocks
    got = {}
    try:
        schur_general.schur_edge_blocks = \
            schur_general.schur_edge_blocks_plain
        got["swapped"] = ba.schur_build(prob, pattern=pat)
    finally:
        schur_general.schur_edge_blocks = real
    got["wrapper"] = ba.schur_build(prob, pattern=pat)
    for k in ("Hll", "b_l"):
        assert torch.equal(got["swapped"][k], got["wrapper"][k])
    for k in ("W_lm", "W_pose"):
        for g in got["wrapper"][k]:
            assert torch.equal(got["swapped"][k][g], got["wrapper"][k][g])
