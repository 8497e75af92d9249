"""Step-time attribution: phase-decomposed step timing, MFU/roofline
accounting per executed signature, a bounded flight recorder and
/profilez (counterpart of ``paddle_tpu/observability/profiling.py``).

- phase timing   the executor wraps each run in ``step_phases(lane,
                 label)`` and brackets the four canonical phases:
                 ``feed_prep`` (feeds into their buffers, scope checks,
                 the random streams reseeded), ``dispatch`` (the graph
                 replay, or the eager op loop), ``device_wait`` (the
                 device work the host waits out) and ``fetch_sync``
                 (scope write-back and fetch copies).  Exported as
                 ``pt_step_phase_seconds{phase,lane}``.
                 FLAGS_profile_phases gates the per-phase work and the
                 device synchronisation ``device_wait`` needs; with it
                 off the recorder still times the step total.

- MFU/roofline   ``note_cost`` (a signature's flops and bytes, which the
                 caller computes: the port has no cost model of its
                 own) and the measured device seconds join a peak table
                 (``device_peaks``: the card's row matched on the name
                 torch reports, FLAGS_device_peak_* overrides) into
                 ``pt_mfu{signature}`` and ``pt_roofline_bound{signature,
                 bound}``.

- flight record  a bounded ring (FLAGS_flight_recorder_steps) of the
                 last steps' records (lane, signature, seconds, phases,
                 the prefetch queue depth where a prefetcher books one)
                 and the health sentinel's events.
                 ``dump_flight_record()`` writes it as a JSONL
                 postmortem; it dumps itself on a slow step (a z-score
                 over the lane's step-time EMA above
                 FLAGS_profile_slow_step_zscore) and on a bad step
                 (``note_health_event``, from health/sentinel.py), at
                 most once a half ring.

- /profilez      a JSON page on every MetricsServer (exposition.py):
                 per-signature MFU and roofline verdict, per-lane phase
                 p50/p95, the feed verdict (prefetch stall seconds over
                 step seconds) and the flight recorder's state.
                 ``attribution_digest()`` is the same, compacted.

Not ported: ``hlo_inventory`` and ``hlo_collective_bytes`` /
``hlo_collective_counts``, which read an XLA HLO module; torch has no
such text (ROADMAP section 3).  Imports are stdlib-only at module
level; torch is read inside functions.
"""

from __future__ import annotations

import collections
import json
import os
import sys
import threading
import time
import warnings

from . import metrics as _metrics
from . import tracing as _tracing

__all__ = [
    "step_phases", "StepPhaseRecorder", "NullRecorder", "note_step",
    "note_cost", "note_health_event", "device_peaks", "roofline",
    "FlightRecorder", "flight_recorder", "dump_flight_record",
    "read_flight_record", "feed_verdict", "profilez_payload",
    "attribution_digest", "ensure_profilez_page", "signature_stats",
    "reset", "record_span", "PHASES",
]

# the canonical phase decomposition of one executed step, in order
PHASES = ("feed_prep", "dispatch", "device_wait", "fetch_sync")

# phases span ~100 us (a feed copy) to seconds (a capture): the default
# latency buckets extended downward so sub-ms phases resolve
_PHASE_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                  0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

_EMA_BETA = 0.9
_EPS = 1e-12


def _m_phase():
    return _metrics.histogram(
        "pt_step_phase_seconds",
        "Wall time of one step decomposed into named phases: feed_prep "
        "(feed buffers, scope checks, random streams), dispatch (graph "
        "replay or the eager op loop), device_wait (device work the host "
        "waited out), fetch_sync (scope write-back + fetch copies)",
        labels=("phase", "lane"), buckets=_PHASE_BUCKETS)


def _m_mfu():
    return _metrics.gauge(
        "pt_mfu",
        "Model FLOPs utilization of the most recent steps per executed "
        "signature: noted flops / (device seconds x peak flops, "
        "FLAGS_device_peak_flops override)",
        labels=("signature",))


def _m_roofline():
    return _metrics.gauge(
        "pt_roofline_bound",
        "Roofline verdict per executed signature: 1 on the bound "
        "(compute|memory|comm) whose peak-rate time lower bound "
        "dominates, 0 elsewhere", labels=("signature", "bound"))


def _m_flight_dumps():
    return _metrics.counter(
        "pt_flight_dumps_total",
        "Flight-recorder JSONL postmortems written, by trigger reason "
        "(slow_step / health / explicit)", labels=("reason",))


def _flag(name):
    from paddle_tpu_torch.fluid import flags

    return flags.flag(name)


def _phases_enabled():
    return bool(_flag("profile_phases"))


# ---------------------------------------------------------------------------
# phase recorder
# ---------------------------------------------------------------------------

_tls = threading.local()


class _PhaseSpan:
    __slots__ = ("_rec", "_name", "_t0")

    def __init__(self, rec, name):
        self._rec = rec
        self._name = name

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, et, ev, tb):
        self._rec._spans.append((self._name, time.perf_counter() - self._t0))
        return False


class _NullSpan:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


def _cuda_devices(values):
    """The CUDA devices of the tensors in (nested lists of) ``values``."""
    import torch

    out, stack = set(), [values]
    while stack:
        v = stack.pop()
        if isinstance(v, (list, tuple)):
            stack.extend(v)
        elif isinstance(v, dict):
            stack.extend(v.values())
        elif isinstance(v, torch.Tensor) and v.is_cuda:
            out.add(v.device)
    return out


class StepPhaseRecorder:
    """Times one executed step.  With FLAGS_profile_phases on,
    ``phase()`` brackets record the named sub-phases and ``wait()``
    synchronises the devices of the step's outputs, so ``device_wait``
    measures the device work the host waited out; with it off both are
    no-ops and only the step total and the signature label are
    deposited for ``note_step``."""

    __slots__ = ("lane", "label", "detailed", "_spans", "_t0")

    def __init__(self, lane, label, detailed):
        self.lane = lane
        self.label = label
        self.detailed = detailed
        self._spans = []  # (phase, seconds)

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def phase(self, name):
        if not self.detailed:
            return _NULL_SPAN
        return _PhaseSpan(self, name)

    def wait(self, values):
        """Block until the device work that made ``values`` is done
        (inside the ``device_wait`` bracket); a no-op with phases off,
        where a per-step synchronisation would cost the pipelining of
        host and device."""
        if not self.detailed:
            return
        import torch

        for dev in _cuda_devices(values):
            torch.cuda.synchronize(dev)

    def __exit__(self, et, ev, tb):
        if et is not None:
            return False
        total = time.perf_counter() - self._t0
        phases = {}
        for name, dur in self._spans:
            phases[name] = phases.get(name, 0.0) + dur
        if phases:
            fam = _m_phase()
            for name, dur in phases.items():
                fam.labels(phase=name, lane=self.lane).observe(dur)
        # handed to note_step on this thread, which the executor calls
        # right after the run returns
        _tls.pending = (self.lane, self.label, phases or None, total)
        return False


class NullRecorder:
    """Recorder-shaped no-op: nothing timed, nothing deposited (for runs
    that must stay out of the attribution stats)."""

    detailed = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def phase(self, name):
        return _NULL_SPAN

    def wait(self, values):
        pass


def step_phases(lane, label, enabled=True):
    """The recorder every executor lane wraps a run in;
    ``enabled=False`` gives the NullRecorder."""
    if not enabled:
        return NullRecorder()
    return StepPhaseRecorder(lane, label, bool(_flag("profile_phases")))


def _pop_pending(lane):
    pending = getattr(_tls, "pending", None)
    if pending is not None and pending[0] == lane:
        _tls.pending = None
        return pending
    return None


# ---------------------------------------------------------------------------
# per-signature stats + MFU/roofline
# ---------------------------------------------------------------------------

_lock = threading.RLock()
_signatures: dict = {}  # label -> stats dict
_lane_ema: dict = {}    # lane -> [ema, emvar, samples] of step seconds


def _sig(label):
    s = _signatures.get(label)
    if s is None:
        s = _signatures[label] = {
            "label": label, "lane": None, "steps": 0,
            "total_s": 0.0, "ema_step_s": None,
            "device_s_sum": 0.0, "device_steps": 0,
            "flops": None, "bytes_accessed": None,
            "collective_bytes": None,
        }
    return s


# device name substring -> (bf16 dense flop/s, HBM bytes/s, interconnect
# bytes/s a direction); NVIDIA's H100 SXM data sheet at its 700 W limit.
# First match wins.
_GPU_PEAKS = (
    ("H100", (989e12, 3.35e12, 450e9)),
)

# order-of-magnitude placeholders for a CPU run (and a card without a
# row): MFU against them is a smoke-test number, not a claim — set
# FLAGS_device_peak_* for anything that matters
_CPU_PEAKS = (1e11, 2.5e10, 1e9)


def _device_name():
    """torch's name of CUDA device 0, or None without a card."""
    import torch

    if not torch.cuda.is_available():
        return None
    return torch.cuda.get_device_name(0)


def device_peaks():
    """(platform, peak flop/s, peak HBM bytes/s, peak interconnect
    bytes/s) of CUDA device 0, "gpu", from the row of ``_GPU_PEAKS``
    whose key the device's name contains (the placeholders for a card
    without a row); "cpu" and the placeholders without a card.
    FLAGS_device_peak_flops / _bandwidth / _ici_bandwidth (nonzero)
    override entry by entry."""
    platform, peaks = "cpu", _CPU_PEAKS
    name = _device_name()
    if name is not None:
        platform = "gpu"
        for pat, p in _GPU_PEAKS:
            if pat in name:
                peaks = p
                break
    flops = float(_flag("device_peak_flops") or 0) or peaks[0]
    bw = float(_flag("device_peak_bandwidth") or 0) or peaks[1]
    ici = float(_flag("device_peak_ici_bandwidth") or 0) or peaks[2]
    return platform, flops, bw, ici


def roofline(flops, bytes_accessed, collective_bytes, peaks=None):
    """The roofline verdict of one step: time lower bounds at the peak
    compute, memory and interconnect rates, and which dominates.
    ``peaks`` defaults to ``device_peaks()``; a missing numerator counts
    0 (an unmeasured axis is never the bound)."""
    if peaks is None:
        _, pf, pbw, pici = device_peaks()
    else:
        pf, pbw, pici = peaks
    t = {
        "compute": (flops or 0.0) / max(pf, _EPS),
        "memory": (bytes_accessed or 0.0) / max(pbw, _EPS),
        "comm": (collective_bytes or 0.0) / max(pici, _EPS),
    }
    bound = max(t, key=t.get)
    return {"bound": bound if t[bound] > 0 else None,
            "t_compute_s": t["compute"], "t_memory_s": t["memory"],
            "t_comm_s": t["comm"]}


def _update_mfu(s):
    """Refresh the pt_mfu / pt_roofline_bound gauges of one signature
    (under _lock, whenever its timing or cost changes)."""
    if not s["device_steps"] or not s["flops"]:
        return
    device_s = s["device_s_sum"] / s["device_steps"]
    if device_s <= 0:
        return
    _, pf, pbw, pici = device_peaks()
    mfu = s["flops"] / device_s / pf
    s["mfu"] = mfu
    _m_mfu().labels(signature=s["label"]).set(mfu)
    rl = roofline(s["flops"], s["bytes_accessed"],
                  s["collective_bytes"], peaks=(pf, pbw, pici))
    s["roofline"] = rl
    fam = _m_roofline()
    for bound in ("compute", "memory", "comm"):
        fam.labels(signature=s["label"], bound=bound).set(
            1.0 if rl["bound"] == bound else 0.0)


def note_cost(label, cost, collective_bytes=None):
    """Record a signature's cost numbers: ``cost`` a dict with "flops"
    and "bytes accessed", as the JAX package's cost analysis names
    them."""
    with _lock:
        s = _sig(label)
        for key, field in (("flops", "flops"),
                           ("bytes accessed", "bytes_accessed")):
            v = cost.get(key)
            if v is not None:
                s[field] = float(v)
        if collective_bytes is not None:
            s["collective_bytes"] = float(collective_bytes)
        _update_mfu(s)


def signature_stats():
    """Snapshot of the per-signature attribution table."""
    with _lock:
        return {k: dict(v) for k, v in _signatures.items()}


# ---------------------------------------------------------------------------
# flight recorder
# ---------------------------------------------------------------------------


class FlightRecorder:
    """Bounded ring of the last N steps' records and health events.
    Dumps a JSONL postmortem on demand or by itself (a slow step, a bad
    step); the automatic dumps come at most once a half ring, so a storm
    of anomalies writes a bounded number of files."""

    def __init__(self, keep=None):
        self._lock = threading.Lock()
        # an explicit keep pins the size; the default follows
        # FLAGS_flight_recorder_steps (a change resizes at the next
        # record)
        self._keep_from_flags = keep is None
        self.keep = int(keep if keep is not None
                        else _flag("flight_recorder_steps"))
        self._ring = collections.deque(maxlen=max(1, self.keep))
        self._seq = 0
        self._since_dump = 0
        self._attempts = 0  # file-name counter; failed writes count too
        self.dumps = 0      # successful writes only
        self.last_dump_path = None
        self.last_dump_reason = None

    def _resize_from_flags(self):
        if not self._keep_from_flags:
            return
        keep = int(_flag("flight_recorder_steps"))
        if keep != self.keep and keep >= 1:
            self.keep = keep
            self._ring = collections.deque(self._ring, maxlen=keep)

    def record(self, rec):
        with self._lock:
            self._resize_from_flags()
            self._seq += 1
            self._since_dump += 1
            self._ring.append(dict(rec, seq=self._seq,
                                   ts=round(time.time(), 6)))

    def snapshot(self):
        with self._lock:
            return list(self._ring)

    def maybe_auto_dump(self, reason, detail=None):
        """A trigger's dump, unless one was written within the last
        keep // 2 records."""
        with self._lock:
            if self._since_dump < max(1, self.keep // 2) and self.dumps:
                return None
        return self.dump(reason=reason, detail=detail)

    def _resolve_dir(self):
        d = _flag("flight_recorder_dir")
        if d:
            return d
        d = os.environ.get("PT_EVENT_LOG_DIR") or _flag("event_log_dir")
        # never the working directory: a dump fires from library code
        import tempfile

        return d or tempfile.gettempdir()

    def dump(self, path=None, reason="explicit", detail=None):
        """Write the ring as JSONL: a meta line, then a line a record,
        oldest first.  Returns the path, or None when the write failed
        (warned; a lost postmortem never stops the run).  The dump count
        and the auto-dump window move only after a successful write."""
        with self._lock:
            records = list(self._ring)
            self._attempts += 1
            n_dump = self._attempts
        try:
            if path is None:
                d = self._resolve_dir()
                os.makedirs(d, exist_ok=True)
                path = os.path.join(
                    d, f"flight_{os.getpid()}_{n_dump:03d}.jsonl")
            meta = {"flight_record": 1, "reason": reason,
                    "ts": round(time.time(), 6), "keep": self.keep,
                    "records": len(records),
                    **_tracing.process_identity()}
            if detail:
                meta["detail"] = detail
            with open(path, "w", encoding="utf-8") as fh:
                fh.write(json.dumps(meta, default=str) + "\n")
                for rec in records:
                    fh.write(json.dumps(rec, default=str) + "\n")
        except OSError as e:
            warnings.warn(f"flight-recorder dump failed: {e}")
            return None
        with self._lock:
            self.dumps += 1
            self._since_dump = 0
            self.last_dump_path = path
            self.last_dump_reason = reason
        _m_flight_dumps().labels(reason=reason).inc()
        from . import events as _events

        if _events.enabled():
            _events.emit("flight_record_dump", reason=reason, path=path,
                         records=len(records))
        return path

    def status(self):
        with self._lock:
            return {"keep": self.keep, "size": len(self._ring),
                    "steps_seen": self._seq, "dumps": self.dumps,
                    "last_dump_path": self.last_dump_path,
                    "last_dump_reason": self.last_dump_reason}


_flight = None


def flight_recorder():
    """The process's flight recorder (made at first use)."""
    global _flight
    if _flight is None:
        with _lock:
            if _flight is None:
                _flight = FlightRecorder()
    return _flight


def dump_flight_record(path=None, reason="explicit"):
    """Write the flight record's postmortem now."""
    return flight_recorder().dump(path=path, reason=reason)


def read_flight_record(path):
    """(meta, records) of one flight-record JSONL file."""
    with open(path, encoding="utf-8") as fh:
        lines = [json.loads(ln) for ln in fh if ln.strip()]
    if not lines:
        return {}, []
    return lines[0], lines[1:]


def _queue_depth_sample():
    """The prefetch queue's depth at this step; None while no prefetcher
    books ``pt_prefetch_queue_depth`` (none is ported yet)."""
    fam = _metrics.REGISTRY.get("pt_prefetch_queue_depth")
    if fam is None:
        return None
    samples = fam._snapshot()["samples"]
    if not samples:
        return None
    return float(next(iter(samples.values())))


# ---------------------------------------------------------------------------
# the step sink (fluid/executor.py _record_step, every lane)
# ---------------------------------------------------------------------------


def note_step(lane, seconds=None, first_run=False):
    """Book one executed step: the per-signature stats (and MFU), the
    slow-step detector and the flight recorder.  Takes the phase
    breakdown the lane's ``step_phases`` recorder left on this thread,
    if any; ``seconds=None`` uses the recorder's own total.  A
    signature's first run (its warm-up and capture) stays out of the
    moving averages and the device time."""
    pending = _pop_pending(lane)
    label, phases = lane, None
    if pending is not None:
        _plane, label, phases, total = pending
        if seconds is None:
            seconds = total
    if seconds is None:
        return
    ensure_profilez_page()
    slow = None
    with _lock:
        s = _sig(label)
        s["lane"] = lane
        s["steps"] += 1
        s["total_s"] += seconds
        if not first_run:
            prev = s["ema_step_s"]
            s["ema_step_s"] = (seconds if prev is None else
                               prev + (1.0 - _EMA_BETA) * (seconds - prev))
            device_s = seconds
            if phases:
                # device time = dispatch + device_wait: from handing the
                # step to the device to its completion
                device_s = (phases.get("dispatch", 0.0)
                            + phases.get("device_wait", 0.0)) or seconds
            s["device_s_sum"] += device_s
            s["device_steps"] += 1
            _update_mfu(s)
            # slow-step z-score over the lane's step-time EMA
            zthresh = float(_flag("profile_slow_step_zscore") or 0)
            ema = _lane_ema.setdefault(lane, [None, 0.0, 0])
            if ema[0] is None:
                ema[0] = seconds
            else:
                dev = seconds - ema[0]
                z = abs(dev) / ((ema[1] + _EPS) ** 0.5)
                if (zthresh > 0 and ema[2] >= 8 and dev > 0
                        and z > zthresh):
                    slow = {"z": round(z, 2), "ema_s": round(ema[0], 6)}
                ema[0] += (1.0 - _EMA_BETA) * dev
                ema[1] = _EMA_BETA * (ema[1]
                                      + (1.0 - _EMA_BETA) * dev * dev)
            ema[2] += 1
    rec = {"kind": "step", "lane": lane, "label": label,
           "seconds": round(seconds, 6), "first_run": bool(first_run)}
    if phases:
        rec["phases"] = {k: round(v, 6) for k, v in phases.items()}
    qd = _queue_depth_sample()
    if qd is not None:
        rec["prefetch_queue_depth"] = qd
    if slow is not None:
        rec["slow_step"] = slow
    fr = flight_recorder()
    fr.record(rec)
    if slow is not None:
        fr.maybe_auto_dump(
            "slow_step", detail={"lane": lane, "seconds": seconds, **slow})


def note_health_event(kind, action, lane, step=None, replay=False):
    """The health sentinel's hook (health/sentinel.py): a bad step lands
    in the flight ring and dumps the postmortem."""
    fr = flight_recorder()
    fr.record({"kind": "health", "event": "bad_step", "detect": kind,
               "action": action, "lane": lane, "step": step,
               "replay": bool(replay)})
    fr.maybe_auto_dump(
        "health", detail={"detect": kind, "action": action, "lane": lane})


# ---------------------------------------------------------------------------
# /profilez and the digest
# ---------------------------------------------------------------------------


def _rq(v):
    return None if v is None else round(float(v), 6)


def _sig4(v):
    """4 significant figures at any magnitude (a tiny model's 1e-8 MFU
    must not round to 0)."""
    return None if v is None else float(f"{float(v):.4g}")


def _phase_quantiles():
    """{lane: {phase: {p50, p95, sum, count}}} from the phase
    histogram."""
    fam = _metrics.REGISTRY.get("pt_step_phase_seconds")
    if fam is None:
        return {}
    out = {}
    snap = fam._snapshot()
    for key, h in snap["samples"].items():
        labels = dict(zip(snap["label_names"], key))
        out.setdefault(labels.get("lane", "?"), {})[
            labels.get("phase", "?")] = {
            "p50": _rq(_metrics.hist_quantile(h, 0.50)),
            "p95": _rq(_metrics.hist_quantile(h, 0.95)),
            "sum": round(h["sum"], 6),
            "count": h["count"],
        }
    return out


def _family_sum(name):
    fam = _metrics.REGISTRY.get(name)
    if fam is None:
        return 0.0
    total = 0.0
    for sample in fam._snapshot()["samples"].values():
        total += sample["sum"] if isinstance(sample, dict) else sample
    return total


def feed_verdict():
    """Prefetch stall seconds (``pt_prefetch_stall_seconds_total``) over
    executed step seconds (``pt_step_seconds``' sum); ``feed_bound``
    when the stall is above 10% of the step time."""
    stall = _family_sum("pt_prefetch_stall_seconds_total")
    steps = _family_sum("pt_step_seconds")
    frac = stall / steps if steps > 0 else 0.0
    return {"stall_seconds_total": round(stall, 6),
            "step_seconds_total": round(steps, 6),
            "stall_fraction": round(frac, 6),
            "feed_bound": bool(steps > 0 and frac > 0.10)}


def _signature_payload(s):
    out = {"lane": s["lane"], "steps": s["steps"],
           "avg_step_s": _rq(s["total_s"] / s["steps"])
           if s["steps"] else None,
           "ema_step_s": _rq(s["ema_step_s"])}
    if s["device_steps"]:
        out["device_s_avg"] = _rq(s["device_s_sum"] / s["device_steps"])
    for k in ("flops", "bytes_accessed", "collective_bytes"):
        if s.get(k) is not None:
            out[k] = s[k]
    if s.get("mfu") is not None:
        out["mfu"] = _sig4(s["mfu"])
    if s.get("roofline"):
        rl = s["roofline"]
        out["roofline"] = {"bound": rl["bound"],
                           "t_compute_s": _sig4(rl["t_compute_s"]),
                           "t_memory_s": _sig4(rl["t_memory_s"]),
                           "t_comm_s": _sig4(rl["t_comm_s"])}
    return out


def profilez_payload():
    """The /profilez body: the attribution state as JSON."""
    platform, pf, pbw, pici = device_peaks()
    return {
        "device": {"platform": platform, "peak_flops": pf,
                   "peak_hbm_bytes_per_s": pbw,
                   "peak_ici_bytes_per_s": pici,
                   "phases_enabled": _phases_enabled()},
        "signatures": {label: _signature_payload(s)
                       for label, s in signature_stats().items()},
        "phase_seconds": _phase_quantiles(),
        "feed": feed_verdict(),
        "flight_recorder": flight_recorder().status(),
    }


def attribution_digest():
    """The attribution compacted for a benchmark record: phase
    quantiles, each signature's MFU and roofline bound, the feed
    verdict and the flight recorder's state."""
    sigs = {}
    for label, s in signature_stats().items():
        ent = {"lane": s["lane"], "steps": s["steps"]}
        if s.get("mfu") is not None:
            ent["mfu"] = _sig4(s["mfu"])
        if s.get("roofline"):
            ent["roofline_bound"] = s["roofline"]["bound"]
        if s["device_steps"]:
            ent["device_s_avg"] = _rq(s["device_s_sum"]
                                      / s["device_steps"])
        sigs[label] = ent
    return {"phase_seconds": _phase_quantiles(),
            "signatures": sigs,
            "feed": feed_verdict(),
            "flight_recorder": flight_recorder().status()}


_page_registered = False
_page_lock = threading.Lock()


def ensure_profilez_page():
    """Register /profilez on the process's exposition servers
    (idempotent; the step sink calls it, so a process that runs steps
    serves the page)."""
    global _page_registered
    if _page_registered:
        return
    with _page_lock:
        if _page_registered:
            return
        from . import exposition as _expo

        try:
            _expo.register_page("/profilez", profilez_payload)
        except ValueError:
            pass  # another renderer owns the path: leave it
        _page_registered = True


def record_span(name, args):
    """A finished request-trace span into the running torch.profiler
    session, if one records: a ``record_function`` range named ``name``
    with ``args`` (its ids and duration) as JSON.  The range marks the
    span's end; its duration is in the args.  No-op when torch is not
    imported or no profiler records."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.autograd._profiler_enabled():
        return
    with torch.profiler.record_function(name, json.dumps(args,
                                                         default=str)):
        pass


def reset():
    """Drop all attribution state (tests)."""
    global _flight
    with _lock:
        _signatures.clear()
        _lane_ema.clear()
        _flight = FlightRecorder()
    _tls.pending = None
