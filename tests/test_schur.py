"""Distributed Schur-complement pose-graph solve vs the dense oracle.

SURVEY.md §7: "keep a replicated single-device path as oracle; test
equivalence before chasing scaling" — fp64 CPU mesh, exact same GN sequence.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpu_icp_slam.backend import pose_graph as pg
from tpu_icp_slam.backend import schur
from tpu_icp_slam.dist import make_mesh
# pytest's prepend import mode puts tests/ on sys.path
from test_pose_graph import _chain_with_loop


@pytest.fixture(scope="module")
def mesh():
    if len(jax.devices()) < 4:
        pytest.skip("needs >= 4 virtual devices")
    return make_mesh(4, axes=("graph",))


def test_plan_partitions_and_separators():
    init, gt, factors = _chain_with_loop(n=16, drift=0.02)
    g = pg.from_arrays(init, factors, dtype=jnp.float64)
    plan = schur.make_plan(g.fi, g.fj, g.weight, g.pose_mask, 4)
    # pose 0 and the loop endpoints are separators; block-crossing chain
    # factors add boundary poses
    assert 0 in plan.separator
    assert 15 in plan.separator
    ints = plan.interior[plan.interior >= 0]
    assert len(set(ints) & set(plan.separator)) == 0
    assert len(ints) + len(plan.separator) == 16
    # every live factor assigned exactly once
    live = np.flatnonzero(np.asarray(g.weight) > 0)
    assigned = plan.fidx[plan.fidx >= 0]
    assert sorted(assigned) == sorted(live)


def test_schur_matches_dense(mesh):
    init, gt, factors = _chain_with_loop(n=16, drift=0.03)
    g = pg.from_arrays(init, factors, dtype=jnp.float64)
    dense_opt, dense_chis = pg.optimize(g, iters=6, damping=1e-9)
    dist_opt, dist_chis = schur.optimize_distributed(
        g, mesh, iters=6, damping=1e-9
    )
    np.testing.assert_allclose(
        np.asarray(dist_opt.poses)[:16],
        np.asarray(dense_opt.poses)[:16],
        rtol=1e-7,
        atol=1e-8,
    )
    np.testing.assert_allclose(dist_chis, np.asarray(dense_chis), rtol=1e-6)


def test_schur_with_padding(mesh):
    init, gt, factors = _chain_with_loop(n=8, drift=0.02)
    g = pg.from_arrays(init, factors, max_keyframes=12, max_factors=16,
                       dtype=jnp.float64)
    dense_opt, _ = pg.optimize(g, iters=3, damping=1e-9)
    dist_opt, _ = schur.optimize_distributed(g, mesh, iters=3, damping=1e-9)
    np.testing.assert_allclose(
        np.asarray(dist_opt.poses)[:8],
        np.asarray(dense_opt.poses)[:8],
        rtol=1e-7,
        atol=1e-8,
    )
