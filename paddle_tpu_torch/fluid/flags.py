"""Global flags: the subset of ``paddle_tpu/fluid/flags.py`` the port's
executor, observability, serving lanes and graph passes read.

Any ``FLAGS_<name>`` environment variable seen at import time seeds the
flag, as in the JAX package; a malformed value warns and keeps the
default.  ``set_flags`` / ``get_flags`` change and read them at run
time (an entry point reads its flags when it is built, not at import).
"""

from __future__ import annotations

import os
import warnings

__all__ = ["flag", "get_flags", "set_flags"]

_FALSY = ("0", "false", "off", "no", "")


def _parse_bool(v):
    return str(v).strip().lower() not in _FALSY


# name -> (default, parser)
_DEFS = {
    # graph-optimization pass selection (passes/framework.py grammar)
    "FLAGS_graph_passes": ("default", str),
    # serving: row buckets; optional sequence buckets for feeds whose
    # dim 1 is dynamic ("" disables sequence padding, e.g. "32,64,128");
    # the continuous batcher's max wait; the admission queue limit; the
    # per-request deadline (0 = none); the decode lane's per-tenant
    # live-request quota (0 = unlimited)
    "FLAGS_serving_batch_buckets": ("1,2,4,8,16", str),
    "FLAGS_serving_seq_buckets": ("", str),
    "FLAGS_serving_batch_timeout_ms": (5, int),
    "FLAGS_serving_max_queue": (256, int),
    "FLAGS_serving_deadline_ms": (0, int),
    "FLAGS_serving_tenant_quota": (0, int),
    # the serving router (serving/router.py): the hedge delay on the
    # stateless lane (0 off, -1 from the router's rolling p99), and the
    # per-replica circuit breaker's consecutive failures to open and its
    # cooldown before one probe
    "FLAGS_serving_hedge_ms": (0, int),
    "FLAGS_serving_breaker_failures": (5, int),
    "FLAGS_serving_breaker_cooldown_ms": (1000, int),
    # retry budget and base backoff of distributed.resilience.RetryPolicy
    # (the router's default policy for typed admission rejections)
    "FLAGS_rpc_retry_times": (3, int),
    "FLAGS_rpc_retry_backoff_ms": (100, int),
    # serving.Engine.load_model(ragged=None): pad every dynamic dim-1
    # feed to ONE length (the largest sequence bucket) so mixed-length
    # traffic batches together; the model masks the tail itself
    # (layers.ragged_attention)
    "FLAGS_ragged_attention": (False, _parse_bool),
    # DecodeEngine(pool_dtype=None) resolves to the dual-int8 KV pool
    "FLAGS_int8_kv_cache": (False, _parse_bool),
    # data-parallel lane (parallel/data_parallel.py): bucketed
    # block-scaled int8 gradient all-reduce, its block size, algorithm
    # ("auto" | "oneshot" | "ring" | "ring_bidir") and the fp32 payload
    # size at which "auto" leaves the one-shot form for the ring
    "FLAGS_quant_allreduce": (False, _parse_bool),
    "FLAGS_quant_allreduce_block_size": (256, int),
    "FLAGS_quant_allreduce_algo": ("auto", str),
    "FLAGS_quant_allreduce_crossover_kb": (256, int),
    # emit each bucket's collective right after its last gradient
    "FLAGS_overlap_allreduce": (True, _parse_bool),
    # keep reduced buckets in the wire format and fuse the dequant into
    # the optimizer ops (kernels/fused_update.py, K8)
    "FLAGS_fused_update": (True, _parse_bool),
    # gradient bucket cap in MB
    "FLAGS_fuse_grad_size_in_MB": (32, int),
    # lanes not ported: DataParallelRunner raises when either is on
    "FLAGS_gspmd_executor": (False, _parse_bool),
    "FLAGS_health_sentinel": (False, _parse_bool),
    # the executor on a CUDA place captures each fixed-shape program
    # once per signature as a CUDA graph and replays it
    # (fluid/executor.py); off runs the eager op loop there too, the
    # counterpart of running the JAX package under jax.disable_jit()
    "FLAGS_cuda_graph_capture": (True, _parse_bool),
    # step-time attribution (observability/profiling.py): decompose
    # every executed step into feed_prep / dispatch / device_wait /
    # fetch_sync phases; off by default, since device_wait synchronizes
    # the device every step
    "FLAGS_profile_phases": (False, _parse_bool),
    # roofline peak overrides (0 = the table in profiling.device_peaks):
    # peak flop/s, HBM bytes/s and interconnect bytes/s of one device
    "FLAGS_device_peak_flops": (0.0, float),
    "FLAGS_device_peak_bandwidth": (0.0, float),
    "FLAGS_device_peak_ici_bandwidth": (0.0, float),
    # directory of the structured JSONL event log
    # (observability/events.py); empty disables it, PT_EVENT_LOG_DIR
    # wins
    "FLAGS_event_log_dir": ("", str),
    # nonzero: this process serves /metricsz, /statusz, /healthz and the
    # registered pages (/servez, /routerz, /tracez, /sloz) on that port
    # (observability/exposition.py ensure_from_flags); 0 = off
    "FLAGS_metrics_port": (0, int),
    # request-scoped serving traces (observability/reqtrace.py) and the
    # completed-trace ring's capacity
    "FLAGS_reqtrace": (True, _parse_bool),
    "FLAGS_reqtrace_ring": (256, int),
    # the flag-driven SLO evaluator (observability/slo.py): its period
    # and its ';'-separated specs (empty: no evaluator)
    "FLAGS_slo_eval_interval_s": (10.0, float),
    "FLAGS_slo_specs": ("", str),
}

_VALUES = {}


def _bootstrap():
    for name, (default, parser) in _DEFS.items():
        _VALUES[name] = default
        env = os.environ.get(name)
        if env is None:
            continue
        try:
            _VALUES[name] = parser(env)
        except (ValueError, TypeError):
            warnings.warn(f"ignoring malformed env {name}={env!r}; using "
                          f"default {default!r}")


def _norm(name):
    return name if name.startswith("FLAGS_") else "FLAGS_" + name


def _known(name):
    key = _norm(name)
    if key not in _DEFS:
        raise KeyError(f"unknown flag {name!r}; known: {sorted(_DEFS)}")
    return key


def flag(name):
    """A flag's value; ``name`` with or without the ``FLAGS_`` prefix."""
    return _VALUES[_norm(name)]


def get_flags(names):
    """{name: value} for a name or a list of names."""
    if isinstance(names, str):
        names = [names]
    return {n: _VALUES[_known(n)] for n in names}


def set_flags(flags):
    """Set flags from a dict; a string value goes through the flag's
    parser, as an environment value does."""
    for n, v in flags.items():
        key = _known(n)
        _VALUES[key] = _DEFS[key][1](v) if isinstance(v, str) else v


_bootstrap()
