"""Measured stage report: reading a synthetic GPU-stream XSpace trace."""

import os

import jax
import pytest

from flowdenoising_tpu.utils.trace_report import (
    _busy_seconds, classify, measured_stage_report)


def _event(meta_id, offset_ns, dur_ns, hlo_op="command_buffer"):
    return (f"events {{ metadata_id: {meta_id} offset_ps: {offset_ns * 1000} "
            f"duration_ps: {dur_ns * 1000} stats {{ metadata_id: 100 "
            f'str_value: "{hlo_op}" }} }}')


def _plane(pid, name, lines, kernels):
    body = [f'id: {pid} name: "{name}"']
    for lid, (lname, events) in enumerate(lines, 1):
        body.append(f'lines {{ id: {lid} name: "{lname}" timestamp_ns: 0 '
                    + " ".join(events) + " }")
    for kid, kname in kernels.items():
        body.append(f'event_metadata {{ key: {kid} value {{ id: {kid} '
                    f'name: "{kname}" }} }}')
    body.append('stat_metadata { key: 100 value { id: 100 name: "hlo_op" } }')
    return "planes { " + " ".join(body) + " }"


def _write_trace(tmp_path, planes):
    text = " ".join(planes)
    raw = jax.profiler.ProfileData.text_proto_to_serialized_xspace(text)
    d = tmp_path / "plugins" / "profile" / "2026_01_01_00_00_00"
    os.makedirs(d)
    (d / "host.xplane.pb").write_bytes(raw)
    return str(tmp_path)


KERNELS = {1: "loop_add_fusion_25", 2: "input_concatenate_fusion_6",
           3: "sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize32x32x8",
           4: "loop_gather_fusion", 5: "input_reduce_fusion_2",
           6: "memcpy32_post", 7: "input_transpose_fusion"}


def test_grouping(tmp_path):
    """Kernels on every GPU stream are summed by the class of their name;
    busy is the union over streams; host planes are ignored."""
    gpu = _plane(1, "/device:GPU:0", [
        ("Stream #13(Compute)", [
            _event(1, 0, 5_000_000),          # elementwise 5 ms
            _event(2, 5_000_000, 1_000_000),  # data movement 1 ms
            _event(3, 6_000_000, 500_000),    # matmul 0.5 ms
            _event(4, 7_000_000, 250_000),    # gather 0.25 ms
            _event(5, 8_000_000, 125_000),    # reduction
            _event(7, 9_000_000, 100_000),    # data movement (transpose)
        ]),
        # a second stream overlapping the first: counted per class, once
        # in busy
        ("Stream #14(MemcpyH2D)", [_event(6, 1_000_000, 2_000_000,
                                          hlo_op="")]),
    ], KERNELS)
    host = _plane(2, "/host:CPU", [("python", [_event(1, 0, 99_000_000)])],
                  KERNELS)
    totals = measured_stage_report(_write_trace(tmp_path, [gpu, host]))
    assert totals is not None
    assert totals["elementwise"] == pytest.approx(5e-3)
    assert totals["data_movement"] == pytest.approx(1.1e-3)
    assert totals["matmul"] == pytest.approx(0.5e-3)
    assert totals["gather"] == pytest.approx(0.25e-3)
    assert totals["reduction"] == pytest.approx(0.125e-3)
    assert totals["memcpy"] == pytest.approx(2e-3)
    # union: [0, 6.5] ms + 0.25 + 0.125 + 0.1 (memcpy hides inside)
    assert totals["busy"] == pytest.approx(6.975e-3)
    assert totals["window"] == pytest.approx(9.1e-3)


def test_no_trace_returns_none(tmp_path):
    assert measured_stage_report(str(tmp_path)) is None


def test_empty_device_lane_returns_none(tmp_path):
    """A trace with no GPU plane (a run on another backend) gives no
    measured report."""
    host = _plane(2, "/host:CPU", [("tf_XLACpu", [_event(1, 0, 5000)])],
                  KERNELS)
    assert measured_stage_report(_write_trace(tmp_path, [host])) is None


@pytest.mark.parametrize("name,stage", [
    ("loop_add_fusion_25", "elementwise"),
    ("loop_multiply_select_fusion_13", "elementwise"),
    ("input_concatenate_fusion_6", "data_movement"),
    ("input_transpose_fusion", "data_movement"),
    ("wrapped_slice", "data_movement"),
    ("sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize64x64x8", "matmul"),
    ("cutlass_80_tensorop_s1688gemm", "matmul"),
    ("loop_gather_fusion_2", "gather"),
    ("input_reduce_fusion", "reduction"),
    ("memcpy32_post", "memcpy"),
    ("MemcpyD2H", "memcpy"),
])
def test_classify_kernel_names(name, stage):
    assert classify(name) == stage


def test_busy_is_interval_union():
    assert _busy_seconds([]) == 0
    assert _busy_seconds([(0, 10), (5, 20), (30, 40)]) == pytest.approx(30e-9)
