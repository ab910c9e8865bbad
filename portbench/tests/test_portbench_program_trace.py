"""The program's spans in the traced run (``portbench/program_trace.py``):
on the CPU the tiny cell reports the four program-span metrics, consistent
with the benchmark's own readings; a program without spans reports none
and raises nothing; the slice's attribution puts each gap down to the
launching thread's innermost span. On the card (``cuda``) both
device-trace metrics come out positive, no span of the program is counted
as a device operation, and the idle share holds with the spans on.
"""

from __future__ import annotations

import types

import pytest
import torch

from portbench import program_trace
from portbench.registry import Registry
from portbench.tests.test_portbench_cpu_runs import CELL, tiny_registry

HOST = [m["name"] for m in program_trace.METRICS
        if m["source"] != "device_trace"]
DEVICE = [m["name"] for m in program_trace.METRICS
          if m["source"] == "device_trace"]
SERVED = ("t5-small.serve-pass", "t5-large.serve-pass")


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny(tmp_path, program=True):
    reg = program_trace.WithProgram(tiny_registry(tmp_path), program)
    return reg.run_cell(CELL, 2 ** 31 + 7, 0.4, torch.device("cpu"), t0=0.0)


def test_cpu_traced_run_reports_the_program_span_metrics(tmp_path):
    out = _tiny(tmp_path)
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert out["correct"] is True
    assert set(HOST) <= set(m) and not set(DEVICE) & set(m)
    ctx = out["_ctx"]
    spans = ctx["program"]["spans"]
    assert spans["mpr.t5.decode.step"]["calls"] == ctx["stats"][
        "decode_steps"]
    assert ctx["program"]["counters"]["t5.decode_steps"] == ctx["stats"][
        "decode_steps"]
    assert 0 < m["server.dispatcher_busy_share"] <= 100
    step = m["t5.decode_launch_ms_per_step"] + m["t5.decode_sync_ms_per_step"]
    assert 0 < step <= m["t5.decode_ms_per_step"]
    assert m["server.queue_wait_ms_per_chunk"] >= 0
    from multimodalpromptretrieval_tpu_torch.train import profiling
    assert not profiling.enabled()


def test_cpu_run_with_the_spans_off_reports_none_of_them(tmp_path):
    out = _tiny(tmp_path, program=False)
    assert out["correct"] is True
    assert not set(HOST + DEVICE) & set(out["metrics"])
    assert "t5.decode_ms_per_step" in out["metrics"]


def test_a_program_without_spans_gives_nothing(monkeypatch):
    from multimodalpromptretrieval_tpu_torch.train import profiling

    monkeypatch.delattr(profiling, "snapshot")
    assert program_trace.program() is None
    program_trace.enable()
    program_trace.reset()
    assert program_trace.snapshot() is None
    ctx = {"stats": {"seconds": 1.0}, "program": None,
           "program_profile": {"window_s": 1.0, "spans": {}, "idle": {}}}
    reg = Registry()
    for name in HOST + DEVICE:
        assert reg.reader(name)(ctx) is None


def _ev(name, start, end, *, thread=0, id=0, cuda=False):
    return types.SimpleNamespace(
        name=name, id=id, thread=thread,
        time_range=types.SimpleNamespace(start=start, end=end),
        device_type=(torch.autograd.DeviceType.CUDA if cuda
                     else torch.autograd.DeviceType.CPU),
        is_user_annotation=name.startswith("mpr."))


def test_gaps_go_to_the_launching_threads_innermost_span():
    D, C = 1, 2  # the dispatcher's and the caller's threads
    events = [
        _ev("mpr.t5.decode", 0, 300, thread=D),
        _ev("mpr.t5.decode.step", 0, 100, thread=D),
        _ev("mpr.t5.decode.eos_sync", 80, 100, thread=D),
        _ev("mpr.t5.decode.step", 101, 200, thread=D),
        _ev("mpr.text.decode", 0, 400, thread=C),
        # launches (runtime calls) and the operations they launched
        _ev("cudaLaunchKernel", 5, 6, thread=D, id=11),
        _ev("gemm", 10, 20, id=11, cuda=True),
        _ev("cudaLaunchKernel", 30, 31, thread=D, id=12),
        _ev("gemm", 40, 45, id=12, cuda=True),
        _ev("cudaMemcpyAsync", 85, 86, thread=D, id=13),
        _ev("Memcpy DtoH", 95, 96, id=13, cuda=True),
        _ev("cudaLaunchKernel", 150, 151, thread=D, id=14),
        _ev("add", 160, 161, id=14, cuda=True),
        _ev("cudaLaunchKernel", 320, 321, thread=C, id=15),
        _ev("copy", 330, 340, id=15, cuda=True),
        # the profiler's device mirror of a span is no operation
        _ev("mpr.t5.decode.step", 10, 45, thread=D, cuda=True),
    ]
    prof = types.SimpleNamespace(events=lambda: events)
    got = program_trace.analyze(prof, 1e-3)
    spans = got["spans"]
    assert spans["mpr.t5.decode.step"]["calls"] == 2
    assert spans["mpr.t5.decode.step"]["kernels"] == 4
    assert spans["mpr.t5.decode.eos_sync"]["kernels"] == 1
    assert spans["mpr.t5.decode"]["kernels"] == 4
    assert spans["mpr.text.decode"]["kernels"] == 1
    assert spans["mpr.t5.decode.step"]["device_s"] == pytest.approx(17e-6)
    idle = got["idle"]
    # 20-40 (middle 30: the first step); 45-95 (middle 70: the first
    # step); 96-160 (middle 128: the second step); 161-330 closed by the
    # caller's copy (middle 245.5: the caller's text decode)
    assert idle["mpr.t5.decode.step"] == pytest.approx((20 + 50 + 64) * 1e-6)
    assert idle["mpr.text.decode"] == pytest.approx(169e-6)
    assert got["unlinked"] == 0


def test_a_gap_inside_the_sync_is_the_syncs():
    events = [
        _ev("mpr.t5.decode.step", 0, 100),
        _ev("mpr.t5.decode.eos_sync", 40, 100),
        _ev("cudaLaunchKernel", 1, 2, id=1),
        _ev("k", 10, 20, id=1, cuda=True),
        _ev("cudaMemcpyAsync", 41, 42, id=2),
        _ev("Memcpy DtoH", 60, 61, id=2, cuda=True),
        _ev("k", 70, 71, id=3, cuda=True),  # its launch is not traced
    ]
    got = program_trace.analyze(types.SimpleNamespace(events=lambda: events),
                                1e-3)
    assert got["idle"] == {"mpr.t5.decode.eos_sync": pytest.approx(40e-6),
                           program_trace.NONE: pytest.approx(9e-6)}
    assert got["unlinked"] == 1


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", SERVED)
def test_card_traced_run_reports_the_device_metrics(cell):
    device = _card()
    seed = 2 ** 31 + 103
    on = program_trace.WithProgram(Registry()).run_cell(cell, seed, 5.0,
                                                        device)
    off = program_trace.WithProgram(Registry(), False).run_cell(
        cell, seed, 5.0, device)
    assert on["correct"] is True and off["correct"] is True
    m = {k: v["value"] for k, v in on["metrics"].items()}
    assert set(HOST + DEVICE) <= set(m)
    assert all(m[k] > 0 for k in DEVICE)
    assert not any(name.startswith("mpr.")
                   for name, _ in on["breakdown"]["device_ops"])
    ctx = on["_ctx"]
    assert ctx["program"]["spans"]["mpr.t5.decode.step"]["calls"] == ctx[
        "stats"]["decode_steps"]
    # the profiler's device mirrors of the spans stay out of the busy
    # time: the idle share moves no more than between runs with the spans
    # off (87.7-92.1% over four t5-large runs on one H100 80GB HBM3 at
    # 700 W, 87.6-88.6% over three t5-small ones)
    idle_on = m["device.idle_share.serve"]
    idle_off = off["metrics"]["device.idle_share.serve"]["value"]
    assert abs(idle_on - idle_off) <= 5.0, (idle_on, idle_off)
    step = m["t5.decode_launch_ms_per_step"] + m["t5.decode_sync_ms_per_step"]
    assert 0.85 * m["t5.decode_ms_per_step"] <= step <= m[
        "t5.decode_ms_per_step"]
