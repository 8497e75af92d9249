"""The port's flight recorder, /profilez, ``feed_verdict`` and
``attribution_digest`` (paddle_tpu_torch/observability/profiling.py)
against the JAX package's: tests/test_profiling.py's flight-recorder,
/profilez and feed-verdict cases run through the port, and the cases
that take no executor run through both packages on the same inputs,
whose payloads must match (exactly, but for file paths and
timestamps).  The postmortem of an injected NaN gradient is the port's
counterpart of ``test_injected_nan_grad_dumps_postmortem``: the port's
Executor under the health sentinel, a skipped step, the dump."""

import torch_port_threads  # noqa: F401  (one torch thread a process)
import json
import urllib.request

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
from paddle_tpu import observability as jobs
from paddle_tpu.observability import profiling as jprof

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import observability as tobs
from paddle_tpu_torch.distributed import fault_injection as tfi
from paddle_tpu_torch.observability import profiling as tprof

_FLAGS = ["FLAGS_profile_phases", "FLAGS_flight_recorder_steps",
          "FLAGS_flight_recorder_dir", "FLAGS_profile_slow_step_zscore",
          "FLAGS_device_peak_flops", "FLAGS_device_peak_bandwidth",
          "FLAGS_device_peak_ici_bandwidth"]

PKGS = {"jax": (jfluid, jprof, jobs.REGISTRY),
        "torch": (tfluid, tprof, tobs.REGISTRY)}


@pytest.fixture
def attribution(tmp_path):
    """Fresh attribution state and the phase flag on, in both packages,
    each dumping into its own directory; all restored after."""
    prior = {k: fluid.get_flags(_FLAGS) for k, (fluid, _, _) in PKGS.items()}
    for k, (fluid, prof, _) in PKGS.items():
        (tmp_path / k).mkdir()
        fluid.set_flags({"FLAGS_profile_phases": True,
                         "FLAGS_flight_recorder_dir": str(tmp_path / k)})
        prof.reset()
    yield tmp_path
    for k, (fluid, prof, _) in PKGS.items():
        fluid.set_flags(prior[k])
        prof.reset()


def _both(fn):
    """fn(fluid, prof, registry) in each package: {pkg: result}."""
    return {k: fn(*v) for k, v in PKGS.items()}


def _strip(rec):
    """A record without its time stamp and without the prefetch queue
    depth, which the JAX package books once any of its prefetchers ran
    in this process (its registry is process-wide; the port has none)."""
    return {k: v for k, v in rec.items()
            if k not in ("ts", "pid", "prefetch_queue_depth")}


def test_flight_ring_is_bounded(attribution):
    def ring(_fluid, prof, _reg):
        fr = prof.FlightRecorder(keep=4)
        for i in range(10):
            fr.record({"kind": "step", "i": i})
        return [_strip(r) for r in fr.snapshot()]

    got = _both(ring)
    assert got["torch"] == got["jax"]
    assert [r["i"] for r in got["torch"]] == [6, 7, 8, 9]
    assert got["torch"][-1]["seq"] == 10


def test_flight_dump_writes_valid_jsonl(attribution):
    def dump(_fluid, prof, reg):
        for _ in range(5):
            prof.note_step("single", 0.001, first_run=False)
        path = prof.dump_flight_record(
            path=str(attribution / f"fr_{prof.__name__}.jsonl"))
        with open(path) as fh:
            for line in fh:
                json.loads(line)  # every line stands alone
        meta, records = prof.read_flight_record(path)
        snap = reg.snapshot()["pt_flight_dumps_total"]
        assert snap["samples"][("explicit",)] >= 1.0
        return ({k: meta[k] for k in ("flight_record", "reason", "keep",
                                      "records")},
                sorted(meta), [_strip(r) for r in records])

    got = _both(dump)
    assert got["torch"] == got["jax"]
    meta, _keys, records = got["torch"]
    assert meta["reason"] == "explicit" and meta["records"] == 5
    assert all(r["kind"] == "step" for r in records)


def test_slow_step_zscore_triggers_auto_dump(attribution):
    def slow(fluid, prof, _reg):
        fluid.set_flags({"FLAGS_profile_slow_step_zscore": 4.0})
        for _ in range(20):
            prof.note_step("dp", 0.01, first_run=False)
        fr = prof.flight_recorder()
        assert fr.dumps == 0
        prof.note_step("dp", 10.0, first_run=False)  # a massive outlier
        assert fr.dumps == 1 and fr.last_dump_reason == "slow_step"
        meta, records = prof.read_flight_record(fr.last_dump_path)
        return meta["detail"], _strip(records[-1])

    got = _both(slow)
    assert got["torch"] == got["jax"]
    assert got["torch"][1]["slow_step"]["z"] > 4.0


def test_health_event_triggers_dump_and_rides_ring(attribution):
    def event(_fluid, prof, _reg):
        prof.note_step("single", 0.01, first_run=False)
        prof.note_health_event("grad", "skip", "single", step=3)
        fr = prof.flight_recorder()
        assert fr.dumps == 1 and fr.last_dump_reason == "health"
        _meta, records = prof.read_flight_record(fr.last_dump_path)
        return [_strip(r) for r in records]

    got = _both(event)
    assert got["torch"] == got["jax"]
    assert got["torch"][-1] == {
        **got["torch"][-1], "kind": "health", "event": "bad_step",
        "detect": "grad", "action": "skip", "lane": "single", "step": 3}


def test_failed_dump_does_not_consume_rate_limit(attribution):
    """A failed write commits neither the dump count nor the rate-limit
    window: the next trigger still writes."""
    blocker = attribution / "not_a_dir"
    blocker.write_text("a file where the dump directory would go")
    tfluid.set_flags({"FLAGS_flight_recorder_dir": str(blocker / "sub")})
    tprof.note_step("single", 0.01, first_run=False)
    with pytest.warns(UserWarning, match="dump failed"):
        assert tprof.dump_flight_record() is None
    fr = tprof.flight_recorder()
    assert fr.dumps == 0 and fr.last_dump_path is None
    tfluid.set_flags({"FLAGS_flight_recorder_dir": str(attribution)})
    tprof.note_health_event("grad", "skip", "single")
    assert fr.dumps == 1 and fr.last_dump_reason == "health"


def test_auto_dumps_rate_limited(attribution):
    def limited(fluid, prof, _reg):
        fluid.set_flags({"FLAGS_flight_recorder_steps": 10})
        prof.reset()  # a ring of the new size
        prof.note_health_event("grad", "skip", "x")
        prof.note_health_event("grad", "skip", "x")
        fr = prof.flight_recorder()
        counts = [fr.dumps]  # the second event is inside the window
        for _ in range(6):
            fr.record({"kind": "step"})
        prof.note_health_event("grad", "skip", "x")
        return counts + [fr.dumps]

    got = _both(limited)
    assert got["torch"] == got["jax"] == [1, 2]


def _fc(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        pred = fluid.layers.fc(x, size=1)
        loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
        fluid.optimizer.SGD(learning_rate=0.05).minimize(loss)
    return main, startup, loss


def _feed(batch=8, seed=0):
    rng = np.random.RandomState(seed)
    xb = rng.uniform(-1, 1, (batch, 4)).astype("float32")
    return {"x": xb, "y": xb @ rng.uniform(-1, 1, (4, 1)).astype(
        "float32")}


def test_injected_nan_grad_dumps_postmortem(attribution):
    """The port's Executor under the health sentinel: the planted NaN
    gradient's step is skipped and the flight recorder dumps a
    postmortem holding the health event and the phase-timed steps."""
    prior = tfluid.get_flags(["FLAGS_health_sentinel",
                              "FLAGS_health_action"])
    tfluid.set_flags({"FLAGS_health_sentinel": True,
                      "FLAGS_health_action": "skip"})
    tfi.install("nan:grad:step:2")
    try:
        main, startup, loss = _fc(tfluid)
        scope = tfluid.Scope()
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(startup, scope=scope)
        for i in range(4):
            exe.run(main, feed=_feed(seed=i), fetch_list=[loss],
                    scope=scope)
        assert np.isfinite(scope.get("fc_0.w_0").numpy()).all()
        fr = tprof.flight_recorder()
        assert fr.dumps >= 1 and fr.last_dump_reason == "health"
        meta, records = tprof.read_flight_record(fr.last_dump_path)
        assert meta["flight_record"] == 1
        assert meta["detail"] == {"detect": "grad", "action": "skip",
                                  "lane": "single"}
        health = [r for r in records if r.get("kind") == "health"]
        assert health and health[0]["detect"] == "grad"
        assert health[0]["step"] == 2
        steps = [r for r in records if r.get("kind") == "step"]
        assert steps and all("phases" in r for r in steps)
    finally:
        tfluid.set_flags(prior)
        tfi.uninstall()


def _payload_shape(p, label):
    """A /profilez payload without what differs run to run: the step
    timings (phase seconds keep their keys) and the dump's path."""
    fr = dict(p["flight_recorder"], last_dump_path=None)
    return {"keys": sorted(p), "device": p["device"],
            "signature": p["signatures"][label],
            "phase_keys": {lane: sorted(ph)
                           for lane, ph in p["phase_seconds"].items()
                           if lane == "payload_test"},
            "feed_keys": sorted(p["feed"]), "flight_recorder": fr}


def test_profilez_payload_and_digest_match_jax(attribution):
    """The same bookings through both packages give the same /profilez
    payload and digest: keys, the device row (the CPU placeholders),
    the signature's numbers, MFU and roofline verdict."""
    label = "payload_test_sig"

    def payload(fluid, prof, _reg):
        fluid.set_flags({"FLAGS_device_peak_flops": 1e9,
                         "FLAGS_device_peak_bandwidth": 1e9,
                         "FLAGS_device_peak_ici_bandwidth": 1e9})
        with prof.step_phases("payload_test", label) as ph:
            with ph.phase("dispatch"):
                pass
        prof.note_step("payload_test", 0.25, first_run=True)
        for s in (0.5, 0.25, 0.75):
            prof._tls.pending = ("payload_test", label,
                                 {"dispatch": s / 2, "device_wait": s / 4},
                                 s)
            prof.note_step("payload_test", s, first_run=False)
        prof.note_cost(label, {"flops": 3e8, "bytes accessed": 1e8},
                       collective_bytes=5e7)
        prof.note_health_event("grad", "skip", "payload_test", step=2)
        digest = prof.attribution_digest()
        return (_payload_shape(prof.profilez_payload(), label),
                sorted(digest), digest["signatures"][label],
                sorted(digest["feed"]))

    got = _both(payload)
    assert got["torch"] == got["jax"]
    shape, digest_keys, sig, _ = got["torch"]
    assert digest_keys == ["feed", "flight_recorder", "phase_seconds",
                           "signatures"]
    assert shape["signature"]["mfu"] > 0
    assert shape["signature"]["roofline"]["bound"] in ("compute", "memory",
                                                       "comm")
    assert sig["roofline_bound"] == shape["signature"]["roofline"]["bound"]


def test_profilez_served_through_real_scrape(attribution):
    tfluid.set_flags({"FLAGS_device_peak_flops": 1e9,
                      "FLAGS_device_peak_bandwidth": 1e9,
                      "FLAGS_device_peak_ici_bandwidth": 1e9})
    main, startup, loss = _fc(tfluid)
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    for i in range(3):
        exe.run(main, feed=_feed(seed=i), fetch_list=[loss], scope=scope)
    (sig,) = exe.compiled_for(main)
    tprof.note_cost(sig.label, {"flops": 1e6, "bytes accessed": 1e5})
    srv = tobs.MetricsServer(port=0)
    try:
        resp = urllib.request.urlopen(
            f"http://{srv.host}:{srv.port}/profilez", timeout=10)
        assert resp.status == 200
        page = json.loads(resp.read())
    finally:
        srv.stop()
    assert sorted(page) == sorted(jprof.profilez_payload())
    ent = page["signatures"][sig.label]
    assert ent["lane"] == "single" and ent["steps"] == 3
    assert ent["mfu"] > 0
    assert ent["roofline"]["bound"] in ("compute", "memory", "comm")
    assert "feed_prep" in page["phase_seconds"]["single"]
    assert page["feed"]["stall_fraction"] >= 0.0
    assert page["flight_recorder"]["size"] > 0
    assert page["device"]["phases_enabled"] is True


def test_feed_verdict_ratio_matches_jax(attribution):
    def verdict(_fluid, prof, reg):
        for fam in ("pt_prefetch_stall_seconds_total", "pt_step_seconds"):
            f = reg.get(fam)
            if f is not None:
                f.clear()
        assert prof.feed_verdict()["feed_bound"] is False
        reg.counter("pt_prefetch_stall_seconds_total", "test").inc(0.5)
        reg.histogram("pt_step_seconds", "test", labels=("path",)).labels(
            path="single").observe(1.0)
        return prof.feed_verdict()

    got = _both(verdict)
    assert got["torch"] == got["jax"]
    assert got["torch"]["stall_seconds_total"] == pytest.approx(0.5)
    assert got["torch"]["feed_bound"] is True
    assert got["torch"]["stall_fraction"] == pytest.approx(0.5)


def test_queue_depth_sample_is_none_without_a_prefetcher(attribution):
    assert tobs.REGISTRY.get("pt_prefetch_queue_depth") is None
    assert tprof._queue_depth_sample() is None
    tprof.note_step("single", 0.01, first_run=False)
    assert "prefetch_queue_depth" not in tprof.flight_recorder().snapshot()[-1]
