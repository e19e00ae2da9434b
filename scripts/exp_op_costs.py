"""Per-op cost breakdown at KITTI scale: where does the frame time go?

Each op is looped N times INSIDE one jit (lax.scan with a value dependency
chained through, so XLA can't CSE the repeats) and fenced with a host
readback (obs.realize), so per-dispatch launch cost is amortized away and
the number isolates the op's device cost.

Usage: PYTHONPATH=src python scripts/exp_op_costs.py
"""
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

import numpy as np

from tpu_icp_slam.obs.compile_cache import enable

enable()

import jax

import json as _json_stamp
from tpu_icp_slam.obs.bench import measurement_stamp as _mstamp
print(_json_stamp.dumps(_mstamp()), flush=True)
import jax.numpy as jnp

from tpu_icp_slam.obs import realize

N_REP = int(os.environ.get("REPS", "20"))
M = 16384  # scan capacity (KITTI regime)
NMAP = 131072  # map capacity
NLOC = 16384  # local model


def timed_loop(tag, fn, *args, reps=N_REP):
    """fn(carry, *args) -> carry; scanned reps times inside ONE jit."""

    @jax.jit
    def run(c, args):
        def body(c, _):
            return fn(c, *args), None

        c, _ = jax.lax.scan(body, c, None, length=reps)
        return c

    c0 = args[0] * 0.0 if isinstance(args[0], jnp.ndarray) else 0.0
    # warmup/compile
    out = run(c0, args[1:])
    realize(out)
    best = np.inf
    for _ in range(3):
        t0 = time.perf_counter()
        out = run(c0, args[1:])
        realize(out)
        best = min(best, time.perf_counter() - t0)
    per = best / reps
    print(f"{tag:34s} {per*1e3:9.3f} ms/op   ({reps} reps, best {best:.3f}s)",
          flush=True)
    return per


rng = np.random.default_rng(0)
src = jnp.asarray(rng.uniform(-40, 40, (M, 3)), jnp.float32)
loc = jnp.asarray(rng.uniform(-40, 40, (NLOC, 3)), jnp.float32)
mappts = jnp.asarray(rng.uniform(-60, 60, (NMAP, 3)), jnp.float32)
mapnrm = jnp.asarray(rng.standard_normal((NMAP, 3)), jnp.float32)
mapmsk = jnp.ones((NMAP,), bool)
srcmsk = jnp.ones((M,), bool)
center = jnp.zeros(3, jnp.float32)

# 1. the Triton NN kernel (the ICP inner-loop op)
from tpu_icp_slam.kernels.nn_pallas import nn_bruteforce_pallas


def nn_op(c, s, d):
    idx, d2 = nn_bruteforce_pallas(s + c[:, None] * 0, d)
    return d2  # carry: (M,) — feeds next rep, defeats CSE


t_nn = timed_loop("NN pallas 16k x 16k", nn_op,
                  jnp.zeros((M,), jnp.float32), src, loc)

# 2. XLA's NN version for reference
from tpu_icp_slam.kernels.nn_xla import nn_bruteforce_xla


def nn_xla_op(c, s, d):
    idx, d2 = nn_bruteforce_xla(s + c[:, None] * 0, d, chunk=2048)
    return d2


t_nn_xla = timed_loop("NN xla 16k x 16k (chunked)", nn_xla_op,
                      jnp.zeros((M,), jnp.float32), src, loc, reps=5)

# 3. extract_local: top_k over the 131k map
from tpu_icp_slam.mapping import voxel_map as vm

vmap_state = vm.create(NMAP)
vmap_state = vm.insert(vmap_state, mappts, mapmsk, mapnrm, voxel=0.2)


def extract_op(c, ctr):
    pts, nrm, msk, r = vm.extract_local(vmap_state, ctr + c * 0, NLOC)
    return jnp.sum(pts[:1, 0]) + r  # scalar carry


t_ex = timed_loop("extract_local top_k 131k->16k", extract_op,
                  jnp.float32(0), center)

# 4. voxel insert (sort-dedup 131k + 16k)


def insert_op(c, p, m, n):
    v2 = vm.insert(vmap_state, p + c * 0, m, n, voxel=0.2,
                   center=jnp.zeros(3))
    return jnp.sum(v2.points[:1, 0])


t_ins = timed_loop("voxel insert 16k into 131k", insert_op,
                   jnp.float32(0), src, srcmsk, mapnrm[:M], reps=10)

# 5. normals_knn 16k (k=8) — runs on keyframe insert
from tpu_icp_slam.mapping.normals import normals_knn


def nrm_op(c, p, m):
    n = normals_knn(p + c * 0, m, k=8)
    return jnp.sum(n[:1, 0])


t_nrm = timed_loop("normals_knn 16k k=8", nrm_op, jnp.float32(0), src, srcmsk,
                   reps=5)

# 6. one full GN iteration worth of solve math (tiny)
from tpu_icp_slam.icp.point_to_plane import build_normal_equations, solve_increment


def gn_op(c, p, q, n, w):
    H, g = build_normal_equations(p + c * 0, q, n, w)
    xi = solve_increment(H, g, 1e-3, 1.0, 0.3)
    return jnp.sum(xi)


t_gn = timed_loop("GN build+solve 16k (xla)", gn_op, jnp.float32(0),
                  src, loc[:M], mapnrm[:M], jnp.ones((M,), jnp.float32))

ITERS = float(os.environ.get("ICP_ITERS", "3.5"))
print(f"\nper-frame estimate at {ITERS} ICP iters:")
print(f"  NN (pallas): {ITERS*t_nn*1e3:7.1f} ms   NN (xla): {ITERS*t_nn_xla*1e3:7.1f} ms")
print(f"  GN solve:    {ITERS*t_gn*1e3:7.1f} ms")
print(f"  extract_local:{t_ex*1e3:7.1f} ms  insert(kf): {t_ins*1e3:7.1f} ms  normals(kf): {t_nrm*1e3:7.1f} ms")
