"""Communication-volume accounting for the distributed paths (SURVEY.md §5;
VERDICT r2 item 8).

The ≥80% 2-host scaling target (BASELINE.json north_star) cannot be
*measured* on one chip, so this module gives the driver the falsifiable
proxy this sandbox permits: exact per-step collective payloads computed
from program parameters, and an analytic compute-vs-interconnect model with
its break-even point. Every formula names the collective that moves the
bytes; `obs/bench.py` rung 5 emits these numbers alongside the (virtual-
device) timing rows, and DESIGN.md §8 interprets them.

Conventions:
- payload = logical tensor size reduced/gathered, in bytes;
- wire bytes per device for a ring all-reduce (psum) of payload P over n
  devices = 2·(n−1)/n · P (reduce-scatter + all-gather halves), the standard
  ring model the scaling-book recipe uses;
- compute rates and link bandwidth come from the published peaks of the
  device kind (obs/peaks.py); an unknown kind is an error.
"""

from __future__ import annotations

import dataclasses

from tpu_icp_slam.obs.peaks import nn_flops, peaks_for


def ring_allreduce_wire_bytes(payload_bytes: float, n_devices: int) -> float:
    """Wire bytes per device for one psum of `payload_bytes` over n devices."""
    if n_devices <= 1:
        return 0.0
    return 2.0 * (n_devices - 1) / n_devices * payload_bytes


def sharded_icp_psum_payload(method: str, d: int = 3,
                             dtype_bytes: int = 4) -> dict:
    """Per-ICP-iteration psum payloads of dist/sharded_icp.py.

    point_to_point: raw Umeyama moments — Σw (1), Σw·p (d), Σw·q (d),
    Σw·p·qᵀ (d²) — plus the 3-float stats vector (Σw, Σw·d², inliers).
    point_to_plane: the 6×6 normal-equation block H (lower-triangle counted
    full — the psum moves the dense tensor), the gradient g (6), plus stats.
    Exactly one psum *pattern* per iteration; the while_loop keeps it on
    device with zero host round-trips (dist/sharded_icp.py:84-96).
    """
    if method == "point_to_plane":
        k = 6 if d == 3 else 3
        floats = k * k + k + 3
    else:
        floats = 1 + d + d + d * d + 3
    return {
        "method": method,
        "floats_per_iteration": floats,
        "payload_bytes_per_iteration": floats * dtype_bytes,
    }


def schur_psum_payload(n_separator: int, d: int = 3,
                       dtype_bytes: int = 4) -> dict:
    """Per-GN-iteration psum payload of the distributed Schur solve.

    One psum of the reduced separator system per iteration: H_SS
    ((Ns·k)² floats, k = 6 twist dims in 3D) + g_S (Ns·k) — see
    backend/schur.py module docstring ("Communication per GN iteration is
    exactly one psum of (Ns·6)² + Ns·6 floats").
    """
    k = 6 if d == 3 else 3
    floats = (n_separator * k) ** 2 + n_separator * k
    return {
        "n_separator": n_separator,
        "floats_per_iteration": floats,
        "payload_bytes_per_iteration": floats * dtype_bytes,
    }


def schur_separator_count(graph, n_blocks: int) -> int:
    """Ns for a concrete graph partition (host-side plan, cheap)."""
    from tpu_icp_slam.backend.schur import make_plan

    plan = make_plan(
        graph.fi, graph.fj, graph.weight, graph.pose_mask, n_blocks
    )
    return int(len(plan.separator))


@dataclasses.dataclass(frozen=True)
class ScalingModel:
    """Analytic 2-host efficiency estimate for one pipeline step.

    compute_mfu: fraction of the fp32 peak the step's compute actually
    sustains — peak-rate compute times make the comm fraction look
    artificially large. Callers pass a measured rate; 1.0 gives the most
    pessimistic (peak-compute) bound.
    """

    compute_flops: float  # per step, total across devices
    comm_payload_bytes: float  # per step, summed psum payloads
    n_devices: int
    device_kind: str
    compute_mfu: float = 1.0

    @property
    def compute_s(self) -> float:
        peak = peaks_for(self.device_kind).fp32_flops
        return self.compute_flops / (self.n_devices * peak * self.compute_mfu)

    @property
    def comm_s(self) -> float:
        wire = ring_allreduce_wire_bytes(
            self.comm_payload_bytes, self.n_devices
        )
        return wire / peaks_for(self.device_kind).link_bytes_per_s

    @property
    def efficiency_bound(self) -> float:
        """Upper bound on parallel efficiency: serial fraction = comm that
        cannot overlap compute (worst case, no overlap)."""
        c, m = self.compute_s, self.comm_s
        return c / (c + m) if (c + m) > 0 else 1.0


def sharded_icp_scaling_model(
    m_points: int, n_points: int, iters: float, n_devices: int,
    device_kind: str, method: str = "point_to_plane",
    compute_mfu: float = 0.05,
) -> dict:
    """Compute-vs-link model for the point-sharded ICP (config 5 front-end).

    Compute = the brute-force NN (obs/peaks.nn_flops per iteration, the
    dominant kernel) at compute_mfu of the fp32 peak; comm = one
    moment/normal-equation psum per iteration. Returns the model row emitted
    by bench rung 5 (see DESIGN.md §8 for the break-even interpretation).
    """
    payload = sharded_icp_psum_payload(method)["payload_bytes_per_iteration"]
    model = ScalingModel(
        compute_flops=nn_flops(m_points, n_points) * iters,
        comm_payload_bytes=payload * iters,
        n_devices=n_devices,
        device_kind=device_kind,
        compute_mfu=compute_mfu,
    )
    return {
        "kind": "sharded_icp",
        "devices": n_devices,
        "compute_flops_per_step": model.compute_flops,
        "psum_payload_bytes_per_step": model.comm_payload_bytes,
        "wire_bytes_per_device_per_step": ring_allreduce_wire_bytes(
            model.comm_payload_bytes, n_devices
        ),
        "compute_s_at_peak": model.compute_s,
        "comm_s": model.comm_s,
        "efficiency_bound": round(model.efficiency_bound, 4),
    }


def schur_scaling_model(
    n_separator: int, n_interior_max: int, n_factors: int, iters: int,
    n_devices: int, device_kind: str, dtype_bytes: int = 4,
    compute_mfu: float = 0.1,
) -> dict:
    """Compute-vs-link model for the distributed Schur solve (config 5
    backend).

    Per-block compute ≈ interior Cholesky ((Ni·6)³/3) + factor linearize
    (~O(F/B · 400 flops)) at compute_mfu of peak (small dense factorizations
    run far below peak); comm = the separator psum per iteration.
    """
    k = 6
    chol = ((n_interior_max * k) ** 3) / 3.0
    linz = 400.0 * n_factors / max(n_devices, 1)
    payload = schur_psum_payload(n_separator, dtype_bytes=dtype_bytes)
    model = ScalingModel(
        compute_flops=(chol + linz) * n_devices * iters,
        comm_payload_bytes=payload["payload_bytes_per_iteration"] * iters,
        n_devices=n_devices,
        device_kind=device_kind,
        compute_mfu=compute_mfu,
    )
    return {
        "kind": "distributed_schur",
        "devices": n_devices,
        "n_separator": n_separator,
        "psum_payload_bytes_per_iteration":
            payload["payload_bytes_per_iteration"],
        "wire_bytes_per_device_per_step": ring_allreduce_wire_bytes(
            model.comm_payload_bytes, n_devices
        ),
        "compute_s_at_peak": model.compute_s,
        "comm_s": model.comm_s,
        "efficiency_bound": round(model.efficiency_bound, 4),
    }
