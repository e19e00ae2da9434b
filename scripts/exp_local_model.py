"""Local-model-size A/B (r5b): the one flagship-scale NN lever not yet tried.

The flagship pays a 16,384x16,384 NN fold per ICP iteration plus the
keyframe normals over the same extracted model. Both scale linearly in the LOCAL MODEL size — the number of map points
extract_local hands to ICP — not in the map itself (131k stays put). The r4
map-op A/B tried extract_approx and a hash insert (both rejected) but never
a smaller extraction.

Risk is coverage: fewer model points around the pose means lower
correspondence yield at corners/frontiers, the r4 boundary-drag class.
A 30-frame fps+ATE read here gates a 200-frame lap arm
(LAP_LMS=8192 scripts/exp_lap_eval.py) before any default flip.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from exp_fast_frame3 import _base, _scans, run_variant  # noqa: E402

import jax  # noqa: E402


def _lm(cfg, n):
    return dataclasses.replace(
        cfg, mapping=dataclasses.replace(cfg.mapping, local_model_size=n)
    )


if __name__ == "__main__":
    scans, gt = _scans()
    from tpu_icp_slam.obs.bench import measurement_stamp
    print(json.dumps(measurement_stamp()), flush=True)
    print(json.dumps({"platform": jax.default_backend(),
                      "frames": len(scans)}), flush=True)
    base = _base()
    variants = {
        "lm16384": base,
        "lm12288": _lm(base, 12288),
        "lm8192": _lm(base, 8192),
    }
    only = os.environ.get("LM_AB_ONLY")
    for name, cfg in variants.items():
        if only and name not in only.split(","):
            continue
        run_variant(name, cfg, scans, gt)
