"""Block-size sweep of the Triton NN kernel against XLA's plain version.

Runs on one GPU at the flagship shape (16,384 scan points against a
16,384-point local model at scene extent, sentinel-padded targets). For
each (block_m, block_n, num_warps, num_stages) it checks the picked
distances against a float64 NumPy brute force on a row subset, then times
ms/call after warm-up. Also times the `vmap`-batched call at the
loop-verification shape (candidates × yaws).

    python scripts/exp_nn_blocks.py            # full sweep
    NN_SWEEP=quick python scripts/exp_nn_blocks.py
"""

from __future__ import annotations

import itertools
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import numpy as np  # noqa: E402

M = N = 16384
N_VALID = 15000  # the rest are PAD_COORD sentinels, as in a local model
ORACLE_ROWS = 1024


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def _time_ms(fn, *args, reps=20) -> float:
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return 1e3 * float(np.median(ts))


def main() -> int:
    card = _card()
    import jax
    import jax.numpy as jnp

    from tpu_icp_slam.core.pointcloud import PAD_COORD
    from tpu_icp_slam.kernels.nn_pallas import nn_bruteforce_pallas
    from tpu_icp_slam.kernels.nn_xla import nn_bruteforce_xla

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"needs a GPU, found {dev.platform}")
    print(f"card: {card}; device_kind: {dev.device_kind}", flush=True)
    rng = np.random.default_rng(0)
    src = rng.uniform(-40, 40, (M, 3)).astype(np.float32)
    src[:, 2] *= 0.1
    dst = np.full((N, 3), PAD_COORD, np.float32)
    dst[:N_VALID] = rng.uniform(-40, 40, (N_VALID, 3))
    dst[:N_VALID, 2] *= 0.1
    sub = src[:ORACLE_ROWS].astype(np.float64)
    oracle = ((sub[:, None] - dst[None].astype(np.float64)) ** 2).sum(-1).min(1)
    s_d, d_d = jnp.asarray(src), jnp.asarray(dst)

    def check(idx):
        picked = ((sub - dst[np.asarray(idx)[:ORACLE_ROWS]]
                   .astype(np.float64)) ** 2).sum(-1)
        return float(np.max(np.abs(picked - oracle)))

    xla = jax.jit(nn_bruteforce_xla)
    rows = [{"impl": "xla", "excess_max_m2": check(xla(s_d, d_d)[0]),
             "ms": _time_ms(xla, s_d, d_d)}]
    print(json.dumps(rows[-1]), flush=True)
    quick = os.environ.get("NN_SWEEP") == "quick"
    grid = itertools.product(
        (16, 32, 64) if not quick else (32,),
        (32, 64, 128) if not quick else (64,),
        (2, 4, 8) if not quick else (4,),
        (1, 3) if not quick else (3,),
    )
    sb = jnp.broadcast_to(s_d, (16, M, 3))
    db = jnp.broadcast_to(d_d, (16, N, 3))
    for bm, bn, nw, ns in grid:
        fn = jax.jit(lambda s, d, bm=bm, bn=bn, nw=nw, ns=ns:
                     nn_bruteforce_pallas(s, d, block_m=bm, block_n=bn,
                                          num_warps=nw, num_stages=ns))
        row = {"impl": "pallas", "block_m": bm, "block_n": bn,
               "num_warps": nw, "num_stages": ns}
        try:
            row["excess_max_m2"] = check(fn(s_d, d_d)[0])
            row["ms"] = _time_ms(fn, s_d, d_d)
            row["vmap16_ms"] = _time_ms(jax.jit(jax.vmap(fn)), sb, db, reps=3)
        except Exception as e:  # a config the compiler refuses is a result
            row["error"] = repr(e)[:300]
        rows.append(row)
        print(json.dumps(row), flush=True)

    # loop-verification shape: (candidates=2) × (yaws=8) batched problems
    print(json.dumps({"impl": "xla", "vmap16_ms": _time_ms(
        jax.jit(jax.vmap(nn_bruteforce_xla)), sb, db, reps=3)}), flush=True)
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
