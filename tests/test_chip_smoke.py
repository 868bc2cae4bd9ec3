"""chip_smoke.py refuses to report success off the GPU."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as S  # noqa: E402


def _fake_child(platform, count=1):
    def run_child(args, env=None, timeout=None):
        return {"platform": platform, "kind": "fake", "count": count,
                "jax": "0", "XLA_FLAGS": ""}, ""
    return run_child


@pytest.mark.parametrize("platform", ["cpu", "rocm"])
def test_device_check_refuses_non_gpu(monkeypatch, platform):
    monkeypatch.setattr(S, "run_child", _fake_child(platform))
    with pytest.raises(S.PhaseFailed, match="not 'gpu'"):
        S.phase_device(1)


def test_device_check_wants_four_cards_for_four(monkeypatch):
    monkeypatch.setattr(S, "run_child", _fake_child("gpu", count=1))
    with pytest.raises(S.PhaseFailed, match="need 4 GPUs"):
        S.phase_device(4)
    monkeypatch.setattr(S, "run_child", _fake_child("gpu", count=4))
    assert S.phase_device(4)["count"] == 4


def test_main_fails_and_prints_no_result_on_cpu(monkeypatch, capsys):
    """A device child reporting platform cpu: exit code 1, no JSON result
    line."""
    monkeypatch.setattr(S, "gpu_line", lambda: "fake card, 700.00 W")
    monkeypatch.setattr(S, "run_child", _fake_child("cpu"))
    assert S.main([]) == 1
    out = capsys.readouterr().out
    assert "FAILED" in out
    assert '"ok": true' not in out


def test_script_exits_nonzero_without_gpu():
    import subprocess
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, S.__file__], capture_output=True,
                       text=True, env=env, timeout=300)
    assert p.returncode != 0
    assert '"ok": true' not in p.stdout
