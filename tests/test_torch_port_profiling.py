"""The port's step-time attribution and event log
(paddle_tpu_torch/observability/profiling.py and events.py) against the
JAX package's functions on the same inputs: the phase recorder,
``note_step`` (a signature's first run kept out of the moving average),
``roofline`` verdicts, ``device_peaks`` (flag overrides, the CPU
placeholder row, the H100 row chosen from the device name) and
``events.emit`` / ``read_events``.  Mirrors tests/test_profiling.py's
recorder, EMA and MFU cases.  The recorder test drives both packages
from one stub clock, so their moving averages compare exactly, and
books its phases on a lane of its own, which no executor uses."""

import torch_port_threads  # noqa: F401  (one torch thread a process)
import time
import types

import pytest

import paddle_tpu.fluid as jfluid
from paddle_tpu import observability as jobs
from paddle_tpu.observability import events as jevents
from paddle_tpu.observability import profiling as jprof

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.observability import events as tevents
from paddle_tpu_torch.observability import metrics as tmetrics
from paddle_tpu_torch.observability import profiling as tprof

_FLAGS = ["FLAGS_profile_phases", "FLAGS_device_peak_flops",
          "FLAGS_device_peak_bandwidth", "FLAGS_device_peak_ici_bandwidth"]

PKGS = {"jax": (jfluid, jprof, jobs.REGISTRY.snapshot),
        "torch": (tfluid, tprof, tmetrics.snapshot)}


@pytest.fixture
def attribution():
    """Fresh attribution state in both packages, phases on; flags and
    state restored after."""
    prior = {k: fluid.get_flags(_FLAGS) for k, (fluid, _, _) in PKGS.items()}
    for fluid, prof, _ in PKGS.values():
        fluid.set_flags({"FLAGS_profile_phases": True})
        prof.reset()
    yield
    for k, (fluid, prof, _) in PKGS.items():
        fluid.set_flags(prior[k])
        prof.reset()


def _counts(snap):
    fam = snap().get("pt_step_phase_seconds")
    return {k: v["count"] for k, v in (fam["samples"] if fam else {}).items()}


def _phase_keys(before, snap, lane):
    """The (phase, lane) samples booked since ``before`` (the registries
    are process-wide: other tests in the process book phases too)."""
    return {k for k, n in _counts(snap).items()
            if k[1] == lane and n > before.get(k, 0)}


class _StubClock:
    """``time`` as a profiling module sees it, with ``perf_counter``
    read from a clock that only ``sleep`` advances."""

    def __init__(self):
        self.now = 0.0

    def perf_counter(self):
        return self.now

    def sleep(self, seconds):
        self.now += seconds


# a lane no executor books, so a run on another thread of the worker
# adds no (phase, lane) key to the test's
_TEST_LANE = "recorder_test"


def test_recorder_deposits_phases_and_total(attribution, monkeypatch):
    got = {}
    for k, (_, prof, snap) in PKGS.items():
        clock = _StubClock()
        monkeypatch.setattr(prof, "time", types.SimpleNamespace(
            perf_counter=clock.perf_counter, time=time.time))
        before = _counts(snap)
        with prof.step_phases(_TEST_LANE, "sig-a") as ph:
            with ph.phase("feed_prep"):
                clock.sleep(0.01)
            with ph.phase("dispatch"):
                clock.sleep(0.005)
        prof.note_step(_TEST_LANE, first_run=False)
        s = prof.signature_stats()["sig-a"]
        got[k] = (s["lane"], s["steps"], s["ema_step_s"],
                  _phase_keys(before, snap, _TEST_LANE))
    (jl, jn, jema, jkeys), (tl, tn, tema, tkeys) = got["jax"], got["torch"]
    assert (tl, tn) == (jl, jn) == (_TEST_LANE, 1)
    assert tema >= 0.015 and tema == jema
    assert {("feed_prep", _TEST_LANE), ("dispatch", _TEST_LANE)} <= tkeys
    assert tkeys == jkeys


def test_recorder_disabled_still_tracks_signature(attribution):
    for k, (fluid, prof, snap) in PKGS.items():
        fluid.set_flags({"FLAGS_profile_phases": False})
        before = _counts(snap)
        with prof.step_phases("dp", "sig-b") as ph:
            with ph.phase("dispatch"):
                pass
            ph.wait(None)  # a no-op, not a device sync
        prof.note_step("dp", first_run=False)
        s = prof.signature_stats()["sig-b"]
        assert s["steps"] == 1 and s["lane"] == "dp", k
        assert not _phase_keys(before, snap, "dp"), k


def test_null_recorder_deposits_nothing(attribution):
    for prof in (jprof, tprof):
        with prof.step_phases("single", "sig-n", enabled=False) as ph:
            with ph.phase("dispatch"):
                pass
        prof.note_step("single", first_run=False)
        assert "sig-n" not in prof.signature_stats()


def test_note_step_first_run_excluded_from_ema(attribution):
    for prof in (jprof, tprof):
        prof.note_step("single", 100.0, first_run=True)
        prof.note_step("single", 0.01, first_run=False)
        prof.note_step("single", 0.03, first_run=False)
    js = jprof.signature_stats()["single"]
    ts = tprof.signature_stats()["single"]
    for key in ("steps", "total_s", "ema_step_s", "device_steps",
                "device_s_sum"):
        assert ts[key] == pytest.approx(js[key]), key
    assert ts["steps"] == 3 and ts["device_steps"] == 2


@pytest.mark.parametrize("args", [
    (1000, 1, 0), (1, 1000, 0), (1, 1, 1000), (0, 0, 0), (10, None, None),
    (None, 5, None)])
def test_roofline_verdicts(args):
    peaks = (100.0, 10.0, 1.0)  # flops/s, bytes/s, ici bytes/s
    assert tprof.roofline(*args, peaks) == jprof.roofline(*args, peaks)


def test_device_peaks_flag_overrides(attribution):
    for fluid, prof, _ in PKGS.values():
        fluid.set_flags({"FLAGS_device_peak_flops": 123.0,
                         "FLAGS_device_peak_bandwidth": 45.0,
                         "FLAGS_device_peak_ici_bandwidth": 6.0})
    assert tprof.device_peaks()[1:] == jprof.device_peaks()[1:] \
        == (123.0, 45.0, 6.0)


def test_device_peaks_cpu_placeholder_row(attribution, monkeypatch):
    """Without a card both packages report the CPU placeholders."""
    monkeypatch.setattr(tprof, "_device_name", lambda: None)
    assert tprof.device_peaks() == jprof.device_peaks()
    assert tprof.device_peaks()[0] == "cpu"


@pytest.mark.parametrize("name,want", [
    ("NVIDIA H100 80GB HBM3", (989e12, 3.35e12, 450e9)),
    ("NVIDIA H100 PCIe", (989e12, 3.35e12, 450e9)),
    ("NVIDIA A100-SXM4-80GB", tprof._CPU_PEAKS)])
def test_device_peaks_gpu_row_from_device_name(attribution, monkeypatch,
                                               name, want):
    """The H100 row is matched on the name torch reports; a card without
    a row keeps the placeholders (override them by flag)."""
    monkeypatch.setattr(tprof, "_device_name", lambda: name)
    assert tprof.device_peaks() == ("gpu",) + want


def test_note_cost_sets_mfu_and_roofline_gauges(attribution):
    got = {}
    for k, (fluid, prof, snap) in PKGS.items():
        fluid.set_flags({"FLAGS_device_peak_flops": 1e6,
                         "FLAGS_device_peak_bandwidth": 1e3,
                         "FLAGS_device_peak_ici_bandwidth": 1e3})
        prof.note_step("single", 1.0, first_run=True)   # warm-up
        prof.note_step("single", 0.5, first_run=False)  # measured
        prof.note_cost("single", {"flops": 1e5, "bytes accessed": 10.0})
        s = prof.signature_stats()["single"]
        sn = snap()
        got[k] = (s["mfu"], s["roofline"],
                  sn["pt_mfu"]["samples"][("single",)],
                  {b: sn["pt_roofline_bound"]["samples"][("single", b)]
                   for b in ("compute", "memory", "comm")})
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == pytest.approx(0.2)
    assert got["torch"][1]["bound"] == "compute"


def test_events_emit_and_read_back(tmp_path):
    """The same emit calls write records that read back with the same
    fields and identity keys in both packages."""
    recs = {}
    for k, ev in (("jax", jevents), ("torch", tevents)):
        path = tmp_path / f"{k}.jsonl"
        log = ev.EventLog(path)
        try:
            log.emit("step", path="single", seconds=0.25, first_run=True)
            log.emit("capture", label="program@1/v0")
        finally:
            log.close()
        recs[k] = ev.read_events(path)
    for j, t in zip(recs["jax"], recs["torch"]):
        assert set(t) == set(j)
        for key in set(t) - {"ts", "mono"}:
            assert t[key] == j[key], key
    assert [r["event"] for r in recs["torch"]] == ["step", "capture"]


def test_events_disabled_without_a_directory(tmp_path, monkeypatch):
    """No FLAGS_event_log_dir and no PT_EVENT_LOG_DIR: disabled, emit is
    a no-op; PT_EVENT_LOG_DIR wins over the flag."""
    monkeypatch.delenv("PT_EVENT_LOG_DIR", raising=False)
    try:
        assert tevents.configure() is None and not tevents.enabled()
        tevents.emit("step", path="single")
        monkeypatch.setenv("PT_EVENT_LOG_DIR", str(tmp_path))
        log = tevents.configure()
        assert log is not None and log.path.startswith(str(tmp_path))
        tevents.emit("step", path="single", seconds=1.0)
        assert tevents.read_events(log.path)[0]["path"] == "single"
    finally:
        monkeypatch.delenv("PT_EVENT_LOG_DIR", raising=False)
        tevents.configure()
