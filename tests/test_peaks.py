"""obs/peaks: published peaks keyed by device kind; unknown kinds raise."""

import pytest

from tpu_icp_slam.obs import peaks


def test_h100_sxm_peaks():
    p = peaks.peaks_for("NVIDIA H100 80GB HBM3")
    assert p.fp32_flops == 67e12
    assert p.tf32_flops == 495e12
    assert p.bf16_flops == 989e12
    assert p.hbm_bytes_per_s == 3.35e12
    assert p.link_bytes_per_s == 450e9


@pytest.mark.parametrize("kind", ["cpu", "AMD Instinct MI300X", "NVIDIA H100 PCIe", ""])
def test_unknown_kind_raises(kind):
    with pytest.raises(ValueError, match="no published peaks"):
        peaks.peaks_for(kind)


@pytest.mark.parametrize("d,per_pair", [(2, 5), (3, 8)])
def test_nn_flops_counts_difference_form(d, per_pair):
    assert peaks.nn_flops(16384, 16384, d) == 16384 * 16384 * per_pair
