"""The reduction of a profiled slice and the readers that take it, on a
made-up profile: busy time is the union of device intervals, idle gaps
are labelled by the host span they fell in, each range's device time is
its kernels', and a share is never made up where nothing was read."""

from __future__ import annotations

import types

import pytest
import torch

from portbench import readers as R
from portbench import trace as T

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


def ev(name, start, end, device=CPU, device_total=0.0):
    return types.SimpleNamespace(name=name, device_type=device,
                                 time_range=types.SimpleNamespace(start=start, end=end),
                                 device_time_total=device_total)


def fake_profile():
    # a 1000 us slice: a decode call on the host 100-400 (its kernels 150-300
    # and 250-350, overlapping), a prefill 500-900 (kernel 600-800), and the
    # device-side copy of a range, which is no operation
    events = [ev(T.SLICE, 0, 1000),
              ev(T.DECODE, 100, 400, device_total=250.0),
              ev(T.MOE, 120, 200, device_total=100.0),
              ev(T.PREFILL, 500, 900, device_total=200.0),
              ev(T.MOE, 520, 560, device_total=50.0),
              ev("bsmm_kernel", 150, 300, CUDA), ev("paged_attn", 250, 350, CUDA),
              ev("flash_fwd", 600, 800, CUDA), ev(T.DECODE, 150, 350, CUDA)]
    return types.SimpleNamespace(events=lambda: events)


def test_reduce_profile():
    p = T.reduce_profile(fake_profile())
    assert p.window_s == pytest.approx(1e-3)
    assert p.busy_s == pytest.approx(400e-6)  # 150-350 and 600-800
    assert p.n_device_events == 3
    assert p.range_device_s[T.DECODE] == (pytest.approx(250e-6), 1)
    assert p.range_device_s[T.MOE] == (pytest.approx(150e-6), 2)
    assert p.range_device_s[T.MOE_IN_DECODE] == (pytest.approx(100e-6), 1)
    # gaps 0-150 and 350-600 fall between calls, 800-1000 inside the prefill
    labels = sorted((lab, round(s * 1e6)) for lab, s in p.gaps)
    assert labels == sorted([(T.HOST_BETWEEN, 150), (T.HOST_BETWEEN, 250),
                             ("admission/prefill", 200)])
    b = T.breakdown(p)
    assert b["device_ops"][0] == ["flash_fwd", pytest.approx(200e-6)]
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10
    assert b["idle_gaps"][0][0].startswith("all gaps:")


def _run(profile, work):
    return types.SimpleNamespace(profile=profile, profiled_work=work)


def test_readers_of_the_slice():
    p = T.reduce_profile(fake_profile())
    run = _run(p, [("decode", 50e-6, 2e9), ("prefill", 100e-6, 5e10)])
    assert R.idle(run) == pytest.approx(60.0)
    assert R.roofline(run, "decode") == pytest.approx(100 * 50 / 250)
    assert R.roofline(run, "prefill") == pytest.approx(100 * 100 / 200)
    assert R.mfu(run) == pytest.approx(100 * 5.2e10 / (1e-3 * 989e12))


def test_no_share_is_made_up():
    assert R.mfu(_run(None, [("decode", 1.0, 1.0)])) is None
    assert R.roofline(_run(None, []), "decode") is None
    p = T.reduce_profile(fake_profile())
    assert R.roofline(_run(p, []), "decode") is None  # no work counted: no share
    empty = types.SimpleNamespace(events=lambda: [ev(T.SLICE, 0, 10)])
    assert R.idle(_run(T.reduce_profile(empty), [])) is None


def test_percentile_is_nearest_rank():
    assert R.percentile([], 95) is None
    assert R.percentile(list(range(1, 101)), 95) == 95
    assert R.percentile([3.0, 1.0, 2.0], 50) == 2.0
    assert R.percentile([1.0] * 9 + [float("inf")], 90) == 1.0
    assert R.percentile([1.0] * 8 + [float("inf")] * 2, 90) == float("inf")
