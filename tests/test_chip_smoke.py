"""chip_smoke.py helpers: phase selection, GPU refusal, the contract line,
and the Triton-call detector, without a card."""

import json
import os
import sys
import types

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def _dev(platform="gpu", kind="NVIDIA H100 80GB HBM3"):
    return types.SimpleNamespace(platform=platform, device_kind=kind)


def test_phase_selection():
    assert chip_smoke.phases_for(False) == ["nn", "flagship", "configs"]
    assert chip_smoke.phases_for(True) == ["four"]


def test_contract_line_format():
    line = chip_smoke.contract_line([_dev()] * 4)
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 4}}
    assert "\n" not in line


@pytest.mark.parametrize("devices", [[_dev("cpu", "cpu")], [_dev("rocm")], []])
def test_require_gpu_refuses(devices):
    with pytest.raises(SystemExit, match="needs an NVIDIA GPU"):
        chip_smoke.require_gpu(devices)


def test_main_refuses_cpu_and_prints_nothing(monkeypatch, capsys):
    import jax

    monkeypatch.setattr(jax, "devices", lambda *a: [_dev("cpu", "cpu")])
    with pytest.raises(SystemExit):
        chip_smoke.main([])
    assert capsys.readouterr().out == ""


def test_triton_call_detection():
    pallas = ('  %pallas_call.8 = (s32[64]{0}) custom-call(f32[64]{0} %p), '
              'custom_call_target="__gpu$xla.gpu.triton", backend_config={}')
    # XLA's own Triton-emitted fusions are not the kernel
    xla_own = ('  %input_reduce_fusion.2 = f32[64]{0} fusion(%a), kind=kCustom, '
               'backend_config={"fusion_backend_config":{"kind":"__triton"}}')
    interpret = ('  %add.1 = s32[64]{0} add(%a, %b), metadata={op_name='
                 '"jit(nn_bruteforce_pallas)/nn_argmin/while/body/add"}')
    assert chip_smoke.triton_calls(pallas) == [pallas]
    assert chip_smoke.triton_calls(xla_own) == []
    assert chip_smoke.triton_calls(interpret) == []
