"""The port's trace attribution (``telemetry.timeline`` / ``profile_scan``)
fixed on a torch-profiler trace the card wrote.

``tests/fixtures/profile_torch/llama3_8b_4l_window.pt.trace.json.gz`` is
the flight recorder's anomaly window from ``chip_smoke.py`` Phase 14a
(Llama-3-8B widths, 4 layers, bf16, ``remat``, B 2 x S 2048, the README
loop; steps 5-7; NVIDIA H100 80GB HBM3, 700.00 W), trimmed by
``chip_smoke.trim_trace`` to what ``timeline`` reads.  Every number below
is the scan of that file, held exactly: device-busy time, the top ops, the
three flash kernels' launches (2L / L / L a step, L = 4) and the step
segmentation by the ``optimizer.step`` spans.
"""

import pathlib
import re

import pytest

from accelerate_tpu_torch.telemetry import profile_scan, timeline

FIXTURE = (pathlib.Path(__file__).resolve().parent / "fixtures" / "profile_torch"
           / "llama3_8b_4l_window.pt.trace.json.gz")
LAYERS = 4
FLASH = {"flash_fwd_sm90_kernel": (24, 4.432), "flash_bwd_dq_sm90_kernel": (12, 2.671),
         "flash_bwd_dkv_sm90_kernel": (12, 3.89)}
MULTIPLY = ("void at::native::(anonymous namespace)::multi_tensor_apply_kernel<at::native::"
            "(anonymous namespace)::TensorListMetadata<1>, at::native::(anonymous namespace)::"
            "BinaryOpScalarFunctor<float, 1, 1, 0>, std::multiplies<float>, float>(at::native::"
            "(anonymous namespace)::TensorListMetadata<1>, at::native::(anonymous namespace)::"
            "BinaryOpScalarFunctor<float, 1, 1, 0>, std::multiplies<float>, float)")
DIVIDE = ("void at::native::(anonymous namespace)::multi_tensor_apply_kernel<at::native::"
          "(anonymous namespace)::TensorListScalarListMetadata<float, 3>, at::native::"
          "(anonymous namespace)::PointwiseOpScalarListFunctor<float, 3, 3, 0>, "
          "std::divides<float> >(at::native::(anonymous namespace)::TensorListScalarListMetadata"
          "<float, 3>, at::native::(anonymous namespace)::PointwiseOpScalarListFunctor<float, 3, "
          "3, 0>, std::divides<float>)")


@pytest.fixture(scope="module")
def report():
    return profile_scan.analyze_trace_dir(str(FIXTURE))


def test_fixture_is_found_and_small():
    assert FIXTURE.stat().st_size <= 200 * 1024
    assert timeline.find_trace_files(str(FIXTURE.parent)) == [str(FIXTURE)]


def test_headline_attribution(report):
    got = {k: v for k, v in report.to_dict().items() if k not in ("source", "steps", "top_ops")}
    assert got == {
        "n_raw_events": 5613, "n_device_events": 5574, "n_device_lanes": 1, "n_scopes": 1,
        "window_ms": 496.392, "device_busy_ms": 474.245, "compute_ms": 474.236,
        "collective_ms": 0.0, "infeed_ms": 0.009, "exposed_collective_ms": 0.0,
        "overlap_fraction": None, "idle_ms": 22.147, "bubble_fraction": 0.0446,
        "step_marker": "optimizer.step"}
    assert report.device_busy_ms <= report.window_ms


def test_top_ops(report):
    assert [(r["name"], r["bucket"], r["count"], r["self_ms"]) for r in report.top_ops] == [
        ("nvjet_tst_320x128_64x3_1x2_h_bz_coopB_NNT", "compute", 51, 44.958),
        ("nvjet_tst_256x128_64x4_1x2_h_bz_coopA_TNT", "compute", 75, 35.236),
        (MULTIPLY, "compute", 552, 33.587),
        (DIVIDE, "compute", 276, 31.845),
        ("nvjet_tst_320x128_64x3_1x2_h_bz_coopB_NTT", "compute", 27, 31.004)]


def test_flash_kernels_at_2l_l_l_a_step():
    wide = profile_scan.analyze_trace_dir(str(FIXTURE), top_k=1000)
    steps = len(wide.steps)
    for base, (count, self_ms) in FLASH.items():
        rows = [r for r in wide.top_ops if re.search(base + r"\b", r["name"])]
        assert len(rows) == 1 and rows[0]["bucket"] == "compute"
        assert (rows[0]["count"], rows[0]["self_ms"]) == (count, self_ms)
    assert [FLASH[k][0] for k in FLASH] == [steps * 2 * LAYERS, steps * LAYERS, steps * LAYERS]


def test_step_segmentation(report):
    assert [{k: s[k] for k in ("index", "start_ms", "dur_ms", "busy_ms", "idle_ms", "compute_ms",
                                "infeed_ms")} for s in report.steps] == [
        {"index": 0, "start_ms": 56.277, "dur_ms": 166.182, "busy_ms": 157.59, "idle_ms": 8.591,
         "compute_ms": 157.587, "infeed_ms": 0.003},
        {"index": 1, "start_ms": 222.459, "dur_ms": 168.656, "busy_ms": 161.057,
         "idle_ms": 7.599, "compute_ms": 161.053, "infeed_ms": 0.003},
        {"index": 2, "start_ms": 391.114, "dur_ms": 105.277, "busy_ms": 102.402,
         "idle_ms": 2.876, "compute_ms": 102.402, "infeed_ms": 0.0}]
    # Each window runs from one optimizer.step span (a host time) to the
    # next.  The host runs ahead of the card: it enters a step's span while
    # the card still runs most of that step's backward (the update's
    # verdict read then waits for it).  So by the card's clock a window
    # holds the end of one step's backward and the start of the next one's
    # forward: one step's worth of device time, and flash launches that add
    # up, with the 5 forward launches before the first span, to the
    # trace's 24 / 12 / 12.
    tl = timeline.build_timeline(timeline.load_trace_events(str(FIXTURE)))
    marker, windows = profile_scan._step_windows(tl)
    assert marker == "optimizer.step" and len(windows) == 3
    ends = [w[0] for w in windows[1:]] + [max(e.end for e in tl.events)]
    per_step = []
    for (start, _), end in zip(windows, ends):
        per_step.append(tuple(sum(1 for e in tl.events if base in e.name and start <= e.ts < end)
                              for base in FLASH))
    before = tuple(sum(1 for e in tl.events if base in e.name and e.ts < windows[0][0])
                   for base in FLASH)
    assert per_step == [(8, 4, 4), (8, 5, 5), (3, 3, 3)] and before == (5, 0, 0)
    assert tuple(map(sum, zip(before, *per_step))) == tuple(c for c, _ in FLASH.values())
    # The device projections of the spans are not markers.
    assert {e.cat for e in tl.host_events} == {"user_annotation"}
