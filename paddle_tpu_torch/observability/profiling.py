"""Step-time attribution: phase-decomposed step timing and MFU/roofline
accounting per executed signature (the part of
``paddle_tpu/observability/profiling.py`` the executor needs).

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

Not ported yet (ROADMAP 1.7): the flight recorder and its slow-step
trigger, ``/profilez`` and the HLO collective inventory.  Imports are
stdlib-only at module level; torch is read inside functions.
"""

from __future__ import annotations

import json
import sys
import threading
import time

from . import metrics as _metrics

__all__ = [
    "step_phases", "StepPhaseRecorder", "NullRecorder", "note_step",
    "note_cost", "device_peaks", "roofline", "signature_stats", "reset",
    "record_span", "PHASES",
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


def _flag(name):
    from paddle_tpu_torch.fluid import flags

    return flags.flag(name)


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


def note_step(lane, seconds=None, first_run=False):
    """Book one executed step into the per-signature stats (and refresh
    its MFU).  Takes the phase breakdown the lane's ``step_phases``
    recorder left on this thread, if any; ``seconds=None`` uses the
    recorder's own total.  A signature's first run (its warm-up and
    capture) stays out of the moving average and the device time."""
    pending = _pop_pending(lane)
    label, phases = lane, None
    if pending is not None:
        _plane, label, phases, total = pending
        if seconds is None:
            seconds = total
    if seconds is None:
        return
    with _lock:
        s = _sig(label)
        s["lane"] = lane
        s["steps"] += 1
        s["total_s"] += seconds
        if first_run:
            return
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
    with _lock:
        _signatures.clear()
    _tls.pending = None
