"""Multi-model serving engine: continuous batcher + shape bookkeeping +
admission control over `AnalysisPredictor` (counterpart of
``paddle_tpu/serving/engine.py``).

  submit(model, feed) ──► edge validation ──► bounded per-model queue
                                                   │ (scheduler thread)
                                                   ▼
                      shape-keyed batch assembly (pad to bucket)
                                                   ▼
                      AnalysisPredictor.run_feed_dict on the engine's
                      device (CUDAPlace(0) unless ``place=`` says
                      otherwise)
                                                   ▼
                      split rows back out ──► per-request futures

Callers never see the batching: `submit` returns a future holding only
that caller's rows; `infer` is the blocking convenience.  Admission is
bounded (FLAGS_serving_max_queue) with typed `ServingOverloadError`
rejection, and every stage reports into the port's metrics registry
(the ``pt_serve_*`` families).

Ragged mode (``load_model(ragged=True)``, default FLAGS_ragged_attention)
pads every dynamic dim-1 feed to the largest sequence bucket, so
mixed-length traffic shares one shape and one batch; the model masks its
padded tail itself from a per-row lengths feed (layers.ragged_attention,
K6).

The JAX package compiles one XLA executable per (model, bucket shape).
The port runs eagerly and compiles nothing; the warm/cold bookkeeping
carries over as is, and "cold" means the first run of a shape key.

Each admitted request gets a serve span (``observability.reqtrace``; a
child of the caller's attached span, else a trace of its own) and each
executed batch a batch span its requests link to; each batch is booked
through ``profiling.step_phases("serve", model)`` and ``note_step``; the
engine shows on ``/servez`` (``serving/status.py``); and a lane turns a
process-level SIGTERM drain (``distributed.elastic``) into
``drain()``.
"""

from __future__ import annotations

import collections
import concurrent.futures
import hashlib
import threading
import time

import numpy as np

from paddle_tpu_torch.distributed import elastic as _elastic
from paddle_tpu_torch.observability import reqtrace as _reqtrace

from .batching import BucketPolicy, Request, assemble_batch, split_outputs, \
    pad_seq
from .errors import (FeedValidationError, ModelNotLoadedError,
                     ServingDeadlineError,
                     ServingOverloadError)

__all__ = ["Engine", "model_signature"]


# ---------------------------------------------------------------------------
# metrics (lazy idempotent registration — the observability contract)
# ---------------------------------------------------------------------------

# request-count buckets for the batch-size histogram: powers of two up to
# the largest sensible serving bucket (latency DEFAULT_BUCKETS would bin
# every batch into the 1-2 bucket)
_BATCH_SIZE_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256)

# distinct tenant labels per model lane; beyond this, new tenants book
# under "__other__" (tenant is caller-supplied — uncapped it would mint
# one permanent registry series per distinct id)
_MAX_TENANT_LABELS = 64


def _m_latency():
    from paddle_tpu_torch import observability as obs

    return obs.histogram(
        "pt_serve_request_latency_seconds",
        "Request latency from submit to completion (includes queueing, "
        "batching wait, and execution)", labels=("model",))


def _m_queue_wait():
    from paddle_tpu_torch import observability as obs

    return obs.histogram(
        "pt_serve_queue_wait_seconds",
        "Queue-entry to batch-formation wait per request — the share of "
        "pt_serve_request_latency_seconds spent queued/batching; an SLO "
        "p99 breach with this phase dominant names admission/batching, "
        "not the device", labels=("model",))


def _m_execute():
    from paddle_tpu_torch import observability as obs

    return obs.histogram(
        "pt_serve_execute_seconds",
        "Batch-formation to futures-resolve time per request — the "
        "execution share of pt_serve_request_latency_seconds (device "
        "dispatch + output split)", labels=("model",))


def _m_batch_size():
    from paddle_tpu_torch import observability as obs

    return obs.histogram(
        "pt_serve_batch_size",
        "Real (pre-padding) rows per executed serving batch — mass above "
        "1 means continuous batching is forming multi-request batches",
        labels=("model",), buckets=_BATCH_SIZE_BUCKETS)


def _m_queue_depth():
    from paddle_tpu_torch import observability as obs

    return obs.gauge(
        "pt_serve_queue_depth",
        "Requests currently queued per model (admission control rejects "
        "beyond FLAGS_serving_max_queue)", labels=("model",))


def _m_rejected():
    # the ONE owner of this family's registration — the decode lane
    # books through this helper too, so the help text can never drift
    # between the two serving lanes
    from paddle_tpu_torch import observability as obs

    return obs.counter(
        "pt_serve_rejected_total",
        "Requests rejected at the admission edge, by reason "
        "(overload / closed / invalid / deadline / tenant_quota / "
        "draining / scheduler_failed)", labels=("model", "reason"))


def _m_requests():
    from paddle_tpu_torch import observability as obs

    return obs.counter(
        "pt_serve_requests_total",
        "Requests admitted, by model and tenant (per-tenant accounting; "
        "capped at 64 distinct tenants per lane, then '__other__')",
        labels=("model", "tenant"))


def _m_rows():
    from paddle_tpu_torch import observability as obs

    return obs.counter(
        "pt_serve_rows_total",
        "Rows served (real) vs padding rows added by bucketing — the "
        "padding overhead of the bucket policy",
        labels=("model", "kind"))


def _m_exec_cache():
    from paddle_tpu_torch import observability as obs

    return obs.counter(
        "pt_serve_executable_cache_total",
        "Serving executable-cache outcomes per dispatched batch: warmup "
        "(explicit warm run), warm (bucket shape already run), "
        "cold (first traffic on a bucket shape — a first run in the "
        "request path)", labels=("model", "result"))


# ---------------------------------------------------------------------------
# model signature
# ---------------------------------------------------------------------------


def _np_dtype(dtype_str):
    """The framework dtype as numpy — None when unresolvable.  Same
    resolution as the edge validation in inference.check_feed_against_var,
    so the serving cast and the edge check can never disagree."""
    from paddle_tpu_torch.inference import _resolve_np_dtype

    return _resolve_np_dtype(dtype_str)


def model_signature(program, feed_names, fetch_names):
    """Stable signature of a loaded model: op types + feed/fetch names +
    static var specs, hashed — the same saved model reloaded in a
    restarted server hashes identically."""
    def stable(v):
        # only hash attr payloads whose repr is process-independent — a
        # sub-block/Variable repr can embed a memory address, which
        # would break the restarted-server-hashes-identically contract
        if isinstance(v, (bool, int, float, str, bytes, type(None))):
            return True
        if isinstance(v, (list, tuple)):
            return all(stable(x) for x in v)
        return False

    h = hashlib.sha1()
    blk = program.global_block()
    for b in program.blocks:  # sub-blocks (while/cond bodies) count too
        for op in b.ops:
            h.update(op.type.encode())
            h.update(b"\x00")  # delimit: ['mat','mul'] != ['matmul']
            for k in sorted(op.attrs):
                v = op.attrs[k]
                if stable(v):
                    h.update(f"{k}={v!r}".encode())
                    h.update(b"\x00")
    # delimit the two lists: feeds=[a,b]/fetches=[c] must not hash the
    # same as feeds=[a]/fetches=[b,c] — different serving interfaces
    for n in sorted(feed_names) + ["\x00fetch\x00"] + sorted(fetch_names):
        v = blk._find_var_recursive(n)
        spec = (n, tuple(v.shape or ()) if v is not None else (),
                v.dtype if v is not None else None)
        h.update(repr(spec).encode())
        h.update(b"\x00")
    return h.hexdigest()[:16]


# ---------------------------------------------------------------------------
# per-model serving lane
# ---------------------------------------------------------------------------


class _ModelLane:
    """One served model: predictor + bounded queue + scheduler thread."""

    def __init__(self, name, predictor, policy, max_wait_s, max_queue,
                 deadline_s=0.0, ragged=False):
        self.name = name
        self.predictor = predictor
        self.policy = policy
        self.max_wait_s = max_wait_s
        self.max_queue = max_queue
        self.deadline_s = float(deadline_s or 0.0)
        # ragged mode (docs/KERNELS.md "Ragged attention"): every
        # dynamic dim-1 feed pads to ONE length (the largest sequence
        # bucket) instead of its nearest bucket, so mixed-length traffic
        # shares a single shape key — it batches TOGETHER (padding rows
        # stop existing for full batches) and warmup runs one
        # executable per batch bucket instead of the seq-bucket cross
        # product.  The model masks the padded tail itself via a
        # per-row lengths feed (layers.ragged_attention).
        self._ragged = bool(ragged)
        if self._ragged and not policy.seq_buckets:
            raise ValueError(
                f"model {name!r}: ragged=True needs sequence buckets to "
                f"name the single padded length (the largest bucket) — "
                f"set FLAGS_serving_seq_buckets or "
                f"Engine(seq_buckets=...)")
        self._ragged_len = policy.seq_buckets[-1] if self._ragged else None
        self.signature = model_signature(predictor._program,
                                         predictor.get_input_names(),
                                         predictor.get_output_names())
        self._var_cache = {}
        # the whole design batches requests along dim 0: a feed var with
        # a FIXED leading dim can neither pad nor concatenate, so reject
        # the model at load with the fix spelled out rather than letting
        # the batcher feed shape-violating batches into the executor
        self._dyn_seq_inputs = []
        for n in predictor.get_input_names():
            v = self._var(n)
            if v is None or v.shape is None:
                continue
            if not len(v.shape):
                raise ValueError(
                    f"model {name!r}: input {n!r} is scalar-shaped "
                    f"(static shape []), so it has no leading batch dim "
                    f"to concatenate requests along — re-export with "
                    f"shape [-1, ...] (layers.data "
                    f"append_batch_size=True)")
            if v.shape[0] not in (-1, None):
                raise ValueError(
                    f"model {name!r}: input {n!r} has a FIXED leading "
                    f"dim {v.shape[0]} (static shape {list(v.shape)}); "
                    f"the serving batcher needs a dynamic batch dim — "
                    f"re-export with shape [-1, ...] "
                    f"(layers.data append_batch_size=True)")
            if len(v.shape) >= 2 and v.shape[1] == -1:
                self._dyn_seq_inputs.append(n)
        dyn_seq_inputs = bool(self._dyn_seq_inputs)
        # without sequence buckets a dynamic dim-1 feed is unwarmable:
        # warmup() cannot synthesize its shapes, so EVERY distinct
        # traffic length pays a cold first run in the request path — warn
        # at load, where the flag fix is still cheap
        if dyn_seq_inputs and not policy.seq_buckets:
            import warnings

            warnings.warn(
                f"model {name!r} has a dynamic dim-1 feed but no "
                f"sequence buckets are configured: warmup() cannot "
                f"warm its shapes, and each distinct sequence "
                f"length will run COLD in the request path — set "
                f"FLAGS_serving_seq_buckets (or Engine(seq_buckets=...))")
        # same contract on the OUTPUT side: split_outputs row-slices
        # every fetch along axis 0, so a batch-reduced or fixed-leading-
        # dim fetch would silently hand request 0 the whole-batch
        # aggregate (computed over padding zeros) and later requests
        # empty arrays — reject at load with the fix named.  Outputs
        # whose dim-1 is dynamic follow the (padded) sequence length;
        # _execute slices those back to each request's pre-pad length so
        # padding positions never reach the caller.
        self._dyn_seq_outputs = set()
        for n in predictor.get_output_names():
            v = self._var(n)
            if v is None or v.shape is None:
                continue
            if len(v.shape) == 0 or v.shape[0] not in (-1, None):
                raise ValueError(
                    f"model {name!r}: output {n!r} has static shape "
                    f"{list(v.shape)} without a dynamic leading (batch) "
                    f"dim; batched serving slices outputs by request "
                    f"rows, so every fetch needs per-row results — "
                    f"fetch the pre-reduction tensor and aggregate "
                    f"client-side (or re-export with a [-1, ...] fetch)")
            if len(v.shape) >= 2 and v.shape[1] == -1:
                self._dyn_seq_outputs.add(n)
        # slice-back on a dyn-declared output is only provably safe once
        # warmup() has OBSERVED its width tracking the fed sequence
        # length (the declaration alone can lie: a constant-width output
        # declared [-1, -1] would be truncated whenever its width
        # collides with a padded bucket).  Until that observation the
        # request path rejects padded traffic typed instead of guessing
        # — bucket-aligned lengths are unaffected.
        self._seq_outputs_confirmed = not (self._dyn_seq_inputs
                                           and self._dyn_seq_outputs)
        self._probe_seqs = None  # set per warmup() by _warmup_shapes
        self._queue = collections.deque()
        # queued rows per shape key, maintained at append/pop/drain so
        # the scheduler's batch-fill wait checks fullness in O(1): the
        # check re-runs on EVERY submit() wakeup, and a full-queue scan
        # there is O(queue × wakeups) inside the lock submit needs
        self._queued_rows = collections.Counter()
        self._cv = threading.Condition()
        # serializes _execute between the scheduler thread and a
        # caller-thread warmup() on a live engine: without it the two
        # would race the _warm bookkeeping
        self._exec_lock = threading.Lock()
        self._thread = None
        self._closed = False
        # graceful drain (drain()): admission stopped, the
        # scheduler finishes the batch in flight, queued futures fail
        # typed with reason="draining"
        self._draining = False
        # warm-shape bookkeeping, keyed on the padded batch shape key: a
        # key is warm once a batch of it has run
        self._warm = set()
        # exec keys of synthetic probe shapes (see _warmup_shapes):
        # warm in _warm so traffic bookkeeping stays exact, but hidden
        # from the warm_executables ops count, which must agree with
        # warmup()'s one-per-bucket-shape return
        self._probe_keys = set()
        self._served_requests = 0
        self._served_batches = 0
        self._warmup_batches = 0  # warmup runs (not in _served_batches)
        self._tenant_requests = collections.Counter()
        # lane-LOCAL executable-cache outcomes for stats(): the
        # pt_serve_* registry counters are process-cumulative, so a
        # re-created engine serving the same model name would inherit a
        # predecessor's cold counts in its hit rate
        self._cache_counts = collections.Counter()
        self._bind_metrics()

    def _bind_metrics(self):
        """Resolve each family's label child ONCE per lane: the hot path
        must not take the process-wide registry lock for a family lookup
        on every request (only the tenant-labeled counter needs a
        per-call .labels() — its label value is caller-supplied).
        Caching breaks the registry's reset() contract ("call sites
        re-register lazily"), so the entry points compare the registry
        epoch (_check_metrics_epoch) and rebind after a reset instead of
        counting into orphaned families forever."""
        from paddle_tpu_torch import observability as obs

        self._metrics_epoch = obs.REGISTRY.epoch
        name = self.name
        self._lat = _m_latency().labels(model=name)
        self._queue_wait = _m_queue_wait().labels(model=name)
        self._execute_hist = _m_execute().labels(model=name)
        self._batch_size = _m_batch_size().labels(model=name)
        self._queue_depth = _m_queue_depth().labels(model=name)
        self._rejected = {r: _m_rejected().labels(model=name, reason=r)
                          for r in ("overload", "closed", "invalid",
                                    "deadline", "draining")}
        self._rows = {k: _m_rows().labels(model=name, kind=k)
                      for k in ("real", "padding")}
        self._exec_cache = {r: _m_exec_cache().labels(model=name, result=r)
                            for r in ("warmup", "warm", "cold")}
        # tenant label values are caller-supplied, so only .labels() can
        # be per-request — but the family lookup itself is cacheable
        self._requests_family = _m_requests()
        # same isolation for latency: the registry histogram is
        # process-cumulative per model name, so snapshot it now and
        # report the DELTA — a fresh lane must not inherit a closed
        # predecessor's p50/p99
        self._lat_baseline = self._lat.hist_data()
        self._queue_wait_baseline = self._queue_wait.hist_data()
        self._execute_baseline = self._execute_hist.hist_data()

    def _check_metrics_epoch(self):
        """One int compare on the hot path; rebinds the cached label
        children iff observability.reset() dropped the families since
        they were resolved.  A concurrent double-rebind is benign (same
        families, same children)."""
        from paddle_tpu_torch import observability as obs

        if self._metrics_epoch != obs.REGISTRY.epoch:
            self._bind_metrics()

    def _serve_span(self, fut, rows, tenant):
        """The engine-side serve span of one admitted request: a child of
        the caller's attached span (router, frontend), else the root of
        a new trace.  It finishes when the request's future resolves."""
        parent = _reqtrace.current_span()
        attrs = {"model": self.name, "tenant": tenant, "rows": rows}
        if parent is not None:
            span = _reqtrace.start_span(
                f"serve:{self.name}", kind="serve", parent=parent,
                attrs=attrs)
        else:
            span = _reqtrace.start_request(
                f"serve:{self.name}", kind="serve", attrs=attrs)
        if span is not None:
            fut.add_done_callback(
                lambda f, s=span: _reqtrace.finish_future(s, f))
        return span

    # -- feed validation edge ---------------------------------------------

    def _var(self, name):
        if name not in self._var_cache:
            self._var_cache[name] = (self.predictor._program.global_block()
                                     ._find_var_recursive(name))
        return self._var_cache[name]

    def _validate_and_pad(self, feed):
        """Edge validation + per-request sequence padding.  Returns
        (padded_feed, rows, shape_key).  Everything a bad caller could
        get wrong fails HERE with a typed error naming the problem —
        never inside the shared batch."""
        from paddle_tpu_torch.inference import check_feed_against_var

        names = self.predictor.get_input_names()
        missing = [n for n in names if n not in feed]
        extra = [n for n in feed if n not in names]
        if missing or extra:
            raise FeedValidationError(
                f"model {self.name!r} expects inputs {names}; "
                f"missing {missing}, unexpected {extra}")
        rows = None
        padded = {}
        key = []
        seq_pads = []
        other_widths = set()  # dim-1 widths of feeds NOT seq-padded
        for n in names:
            arr = np.asarray(feed[n])
            var = self._var(n)
            if arr.ndim == 0:
                raise FeedValidationError(
                    f"input {n!r} must have a leading batch dim; got a "
                    f"scalar")
            check_feed_against_var(n, arr, var,
                                   error_cls=FeedValidationError)
            if rows is None:
                rows = int(arr.shape[0])
            elif int(arr.shape[0]) != rows:
                raise FeedValidationError(
                    f"inconsistent request rows: {n!r} has "
                    f"{arr.shape[0]}, expected {rows}")
            if var is not None and var.dtype is not None \
                    and var.dtype != "":  # bool's proto enum is 0: no
                # truthiness here.
                # cast to the var dtype NOW (the executor would coerce
                # anyway): the shape key must reflect the post-coercion
                # dtype, or a float64 caller would segregate into its
                # own batch lane and falsely book cold executables.
                # Cast BEFORE any sequence pad so the pad's allocation
                # and concat run at the var's width, not the caller's
                # possibly wider dtype (a float64 feed would otherwise
                # pay a full padded-array copy twice)
                want = _np_dtype(var.dtype)
                if want is not None and arr.dtype != want:
                    arr = arr.astype(want)
            if (self.policy.seq_buckets and arr.ndim >= 2
                    and var is not None and var.shape is not None
                    and len(var.shape) >= 2 and var.shape[1] == -1):
                orig = int(arr.shape[1])
                if self._ragged:
                    # one shape for ALL lengths: mixed-length traffic
                    # must share a batch, so over-length can't fall
                    # through to an unpadded cold shape like the
                    # bucketed path allows — reject typed instead
                    if orig > self._ragged_len:
                        raise FeedValidationError(
                            f"input {n!r} has length {orig}, above the "
                            f"ragged lane's single padded length "
                            f"{self._ragged_len} (the largest sequence "
                            f"bucket) — raise the bucket set or split "
                            f"the request")
                    tgt = self._ragged_len
                else:
                    tgt = self.policy.seq_bucket(orig)
                arr = pad_seq(arr, tgt)
                seq_pads.append((orig, tgt))
            elif arr.ndim >= 2:
                other_widths.add(int(arr.shape[1]))
            padded[n] = arr
            key.append((n, tuple(arr.shape[1:]), str(arr.dtype)))
        if rows is None:
            raise FeedValidationError("empty feed")
        if rows == 0:
            # fail at the edge like every other malformed feed: letting
            # a zero-row request through would burn the full batch
            # timeout plus a device dispatch on pure padding, then
            # resolve with empty arrays
            raise FeedValidationError(
                f"request has 0 rows (feed arrays have a zero-length "
                f"batch dim) — nothing to serve")
        if rows > self.policy.max_rows:
            raise FeedValidationError(
                f"request of {rows} rows exceeds the largest batch "
                f"bucket {self.policy.max_rows} — split the request "
                f"(buckets: {list(self.policy.batch_buckets)})")
        # slice-back mapping {padded_len: orig_len}: an output whose
        # dim-1 equals a padded length slices back to that feed's
        # original length.  The mapping is ambiguous only when two
        # different original lengths land on the SAME padded length
        # (which original would the output follow?) — reject that at
        # the edge (when the model has dynamic-length outputs) rather
        # than silently handing the caller positions computed from
        # padding zeros.  Differing lengths on different buckets are
        # fine (the seq2seq src/tgt case).
        seq_pad = None
        if seq_pads:
            by_padded = {}
            for orig, tgt in seq_pads:
                by_padded.setdefault(tgt, set()).add(orig)
            if self._dyn_seq_outputs and any(
                    len(origs) > 1 for origs in by_padded.values()):
                raise FeedValidationError(
                    f"request's dynamic dim-1 feeds have differing "
                    f"lengths {sorted(set(p[0] for p in seq_pads))} "
                    f"padding onto one bucket, and model {self.name!r} "
                    f"has dynamic-length outputs "
                    f"({sorted(self._dyn_seq_outputs)}): padding could "
                    f"not be sliced back unambiguously — pad the feeds "
                    f"to one common length at the caller")
            # an output is matched to its feed by padded length, so a
            # NON-padded feed sharing that width makes the match
            # uncertain — skip slicing there rather than risk
            # truncating valid positions that followed the other feed
            # (the caller sees zero padding, never silent data loss)
            seq_pad = {tgt: next(iter(origs))
                       for tgt, origs in by_padded.items()
                       if next(iter(origs)) != tgt
                       and tgt not in other_widths} or None
            if seq_pad and self._dyn_seq_outputs \
                    and not self._seq_outputs_confirmed:
                raise FeedValidationError(
                    f"model {self.name!r} declares dynamic-length "
                    f"outputs ({sorted(self._dyn_seq_outputs)}) but "
                    f"warmup() has not yet verified which of them "
                    f"actually track the fed sequence length, so this "
                    f"padded request could not be sliced back safely — "
                    f"call Engine.warmup() before serving, or pad feeds "
                    f"to a bucket length "
                    f"({list(self.policy.seq_buckets)}) at the caller")
        return padded, rows, tuple(key), seq_pad

    # -- submission --------------------------------------------------------

    def submit(self, feed, tenant):
        self._check_metrics_epoch()
        try:
            padded, rows, key, seq_pad = self._validate_and_pad(feed)
        except FeedValidationError:
            self._rejected["invalid"].inc()
            raise
        fut = concurrent.futures.Future()
        tenant = str(tenant)
        with self._cv:
            if self._closed:
                self._rejected["closed"].inc()
                raise ServingOverloadError(
                    f"model {self.name!r}: engine is closed",
                    reason="closed")
            if self._draining:
                self._rejected["draining"].inc()
                raise ServingOverloadError(
                    f"model {self.name!r}: engine is draining (graceful "
                    f"preemption) — resubmit to another replica",
                    reason="draining")
            if len(self._queue) >= self.max_queue:
                self._rejected["overload"].inc()
                raise ServingOverloadError(
                    f"model {self.name!r}: queue at admission limit "
                    f"({self.max_queue} requests, "
                    f"FLAGS_serving_max_queue) — retry with backoff",
                    reason="overload")
            # tenant is a caller-supplied string feeding a metric label:
            # cap its cardinality or a per-user/per-request id scheme
            # grows the registry without bound
            if tenant not in self._tenant_requests and \
                    len(self._tenant_requests) >= _MAX_TENANT_LABELS:
                tenant = "__other__"
            req = Request(padded, rows, tenant, fut, key, seq_pad,
                          deadline_s=self.deadline_s)
            req.span = self._serve_span(fut, rows, tenant)
            self._queue.append(req)
            self._queued_rows[key] += rows
            self._queue_depth.set(len(self._queue))
            self._tenant_requests[tenant] += 1
            self._cv.notify_all()
        self._requests_family.labels(model=self.name, tenant=tenant).inc()
        return fut

    # -- scheduler ---------------------------------------------------------

    def start(self):
        # under the lane lock: two Engine.start() calls racing the
        # None-check would each spawn a scheduler thread, and close()
        # would join only the survivor of the overwrite
        with self._cv:
            if self._thread is not None or self._closed:
                return
            self._thread = threading.Thread(
                target=self._scheduler, daemon=True,
                name=f"pt-serve-{self.name}")
            self._thread.start()

    def _matching_rows(self, key):
        return self._queued_rows[key]  # missing key reads 0, no insert

    def _expire_queued(self):
        """Under _cv: resolve every queued request past its per-request
        deadline with a typed ServingDeadlineError (booked as
        reason="deadline") and drop it from the queue — a stale request
        must neither wait forever behind other shape keys nor burn a
        device dispatch its caller already gave up on."""
        if self.deadline_s <= 0:
            return
        now = time.monotonic()
        if not any(r.deadline is not None and now > r.deadline
                   for r in self._queue):
            return
        kept = collections.deque()
        for r in self._queue:
            if r.deadline is None or now <= r.deadline:
                kept.append(r)
                continue
            left = self._queued_rows[r.shape_key] - r.rows
            if left > 0:
                self._queued_rows[r.shape_key] = left
            else:
                self._queued_rows.pop(r.shape_key, None)
            self._rejected["deadline"].inc()
            if r.future.set_running_or_notify_cancel():
                r.future.set_exception(ServingDeadlineError(
                    f"model {self.name!r}: request exceeded its "
                    f"{self.deadline_s * 1000:.0f} ms deadline while "
                    f"queued (FLAGS_serving_deadline_ms)"))
        self._queue = kept
        self._queue_depth.set(len(self._queue))

    def _take_batch(self):
        """Pop the next batch: FIFO head anchors the shape key; requests
        sharing it join until the largest bucket fills or the head's
        max-wait deadline passes.  Other shape keys stay queued; queued
        requests past their per-request deadline expire typed."""
        with self._cv:
            while True:
                while not self._queue and not self._closed:
                    # bounded wait: an idle lane must still observe a
                    # process-level SIGTERM drain (nothing queues on a
                    # draining lane, so no submit would wake it)
                    if not self._draining and _elastic.drain_requested():
                        # the queue is empty under the lock: setting the
                        # flag is the whole drain here
                        self._draining = True
                    self._cv.wait(timeout=0.5)
                if not self._queue:
                    return None  # closed and drained
                # a process drain seen here fails the woken queue typed
                # before any of it reaches the device
                if not self._draining and _elastic.drain_requested():
                    # drain() takes the lock itself and resolves futures,
                    # whose callbacks may call back in
                    self._cv.release()
                    try:
                        self.drain()
                    finally:
                        self._cv.acquire()
                    continue
                self._expire_queued()
                if not self._queue:
                    if self._closed:
                        return None
                    continue
                head = self._queue[0]
                deadline = head.t_arrival + self.max_wait_s
                if head.deadline is not None:
                    # a deadline-bearing head must not spend its whole
                    # budget waiting for batch-mates (a lone request
                    # with deadline < max_wait would otherwise be held
                    # the full max_wait and then burn a device dispatch
                    # on a result only the in-flight check could
                    # discard): wait at most HALF the deadline window,
                    # leaving the other half for execution
                    deadline = min(deadline,
                                   head.t_arrival + self.deadline_s / 2)
                while (self._matching_rows(head.shape_key)
                       < self.policy.max_rows):
                    remaining = deadline - time.monotonic()
                    if remaining <= 0 or self._closed:
                        break
                    self._cv.wait(timeout=remaining)
                # the wait may have outlived some deadlines (including
                # the head's): expire now, and re-anchor if the head
                # itself is gone
                self._expire_queued()
                if not self._queue:
                    if self._closed:
                        return None
                    continue
                if self._queue[0] is head:
                    break
            batch, rows, rest = [], 0, collections.deque()
            for r in self._queue:
                if (r.shape_key == head.shape_key
                        and rows + r.rows <= self.policy.max_rows):
                    batch.append(r)
                    rows += r.rows
                else:
                    rest.append(r)
            self._queue = rest
            left = self._queued_rows[head.shape_key] - rows
            if left > 0:
                self._queued_rows[head.shape_key] = left
            else:
                del self._queued_rows[head.shape_key]
            self._queue_depth.set(len(self._queue))
            return batch

    def _scheduler(self):
        while True:
            batch = self._take_batch()
            if batch is None:
                return
            self._execute(batch)

    # -- execution ---------------------------------------------------------

    def _execute(self, batch, warmup=False):
        self._check_metrics_epoch()
        # batch-formation timestamp: the boundary between the two halves
        # of the request-latency split (pt_serve_queue_wait_seconds /
        # pt_serve_execute_seconds) — taken BEFORE the exec lock, so a
        # warmup holding the lock counts as execution pressure, not as
        # a mysteriously long queue
        t_batch = time.monotonic()
        with self._exec_lock:
            self._execute_locked(batch, t_batch, warmup=warmup)

    def _execute_locked(self, batch, t_batch, warmup=False):
        from paddle_tpu_torch.observability import profiling as _profiling

        rows = sum(r.rows for r in batch)
        bucket = self.policy.batch_bucket(rows)
        # warmup batches stay out of the attribution (NullRecorder), as
        # they stay out of the latency histograms below
        ph = _profiling.step_phases("serve", self.name, enabled=not warmup)
        # one shared batch span: every traced request of the batch links
        # to it (fan-in)
        bspan = None
        if not warmup:
            bspan = _reqtrace.start_batch(
                f"batch:{self.name}",
                attrs={"model": self.name, "rows": rows, "bucket": bucket})
        ph.__enter__()
        try:
            with ph.phase("feed_prep"):
                feed, slices = assemble_batch(batch, bucket)
            exec_key = (bucket, batch[0].shape_key)
            if warmup:
                result = "warmup"
            else:
                result = "warm" if exec_key in self._warm else "cold"
            # validate=False: every request was already validated at
            # submit against the lane's cached vars
            with ph.phase("dispatch"):
                outputs = self.predictor.run_feed_dict(feed,
                                                       validate=False)
            # booked only after the run succeeds: a failed batch must
            # not count phantom warm/cold dispatches (each retry would
            # re-book "cold" and drag the hit rate toward 0)
            self._exec_cache[result].inc()
            self._cache_counts[result] += 1
            # under _cv: stats() iterates _warm (set subtraction) on the
            # exposition handler thread, and a concurrent resize would
            # raise mid-iteration there (membership tests above don't
            # iterate and stay lock-free)
            with self._cv:
                self._warm.add(exec_key)
            # split_outputs also slices dynamic-dim-1 outputs back to
            # each request's pre-pad sequence length: padding positions
            # must not reach the caller
            with ph.phase("fetch_sync"):
                per_req = split_outputs(
                    outputs, slices, seq_pads=[r.seq_pad for r in batch],
                    dyn_seq=self._dyn_seq_outputs)
        except BaseException as e:
            # covers post-run splitting/slicing too: an exception there
            # must fail the batch's futures, not kill the scheduler
            # thread and leave callers blocked forever (no future is
            # resolved before this point, so the fan-out never races a
            # set_result)
            ph.__exit__(type(e), e, None)
            if bspan is not None:
                bspan.finish("error", error=e)
            for r in batch:
                if not r.future.set_running_or_notify_cancel():
                    continue
                r.future.set_exception(e)
            if isinstance(e, (KeyboardInterrupt, SystemExit)):
                raise
            return
        ph.__exit__(None, None, None)
        if not warmup:
            # a cold batch ran its shape's first run (and capture) in the
            # request path: first_run keeps it out of the moving average
            _profiling.note_step("serve", first_run=(result != "warm"))
        now = time.monotonic()
        execute_s = max(now - t_batch, 0.0)
        for r, out in zip(batch, per_req):
            if (not warmup and r.deadline is not None
                    and now > r.deadline):
                # in-flight deadline miss: the result exists but the
                # caller's budget is spent — resolve typed (and book it)
                # rather than hand back an answer it stopped waiting for
                self._rejected["deadline"].inc()
                if r.future.set_running_or_notify_cancel():
                    r.future.set_exception(ServingDeadlineError(
                        f"model {self.name!r}: request exceeded its "
                        f"{self.deadline_s * 1000:.0f} ms deadline in "
                        f"flight (FLAGS_serving_deadline_ms)"))
                continue
            if r.span is not None:
                # attrs and the fan-in link land before set_result:
                # resolving the future finishes the serve span
                if bspan is not None:
                    r.span.link(bspan)
                r.span.set_attr("queue_wait_s",
                                max(t_batch - r.t_arrival, 0.0))
                r.span.set_attr("execute_s", execute_s)
            if r.future.set_running_or_notify_cancel():
                r.future.set_result(out)
            if not warmup:
                # warmup latency must not pollute the histograms traffic
                # is judged by.  The split: queue_wait (submit -> batch
                # formation) + execute (batch formation -> resolve) ≈
                # the total latency, so a p99 breach names its phase
                self._lat.observe(
                    max(now - r.t_arrival, 0.0),
                    exemplar=(r.span.trace_id if r.span is not None
                              else None))
                self._queue_wait.observe(
                    max(t_batch - r.t_arrival, 0.0))
                self._execute_hist.observe(execute_s)
        if bspan is not None:
            bspan.finish("ok", n_requests=len(batch))
        if warmup:
            self._warmup_batches += 1
        else:
            self._batch_size.observe(rows)
            self._rows["real"].inc(rows)
            self._rows["padding"].inc(bucket - rows)
            self._served_requests += len(batch)
            self._served_batches += 1

    # -- warmup ------------------------------------------------------------

    # warmup runs the cross product of sequence buckets over the model's
    # dynamic dim-1 feeds (traffic may pad different feeds to different
    # buckets — the seq2seq src/tgt case); beyond this many combinations
    # per batch bucket, warn and truncate VISIBLY (the un-warmed rest
    # still serves, books cold, and shows up in
    # pt_serve_executable_cache_total)
    _MAX_SEQ_COMBOS = 64

    def _warmup_shapes(self):
        """Zero-feed (rows, trailing) combinations covering the bucket
        set: every batch bucket × every assignment of sequence buckets
        to the dynamic dim-1 feeds (the request path pads each such
        feed independently, so mixed-length assignments are reachable
        traffic, not just the uniform diagonal).  Feeds with OTHER
        dynamic dims can't be synthesized and are skipped (their first
        traffic shape runs cold — and books as such)."""
        import itertools

        names = self.predictor.get_input_names()
        dyn = self._dyn_seq_inputs
        if dyn and self._ragged:
            # ragged lane: every dynamic feed always pads to the ONE
            # ragged length, so the only reachable assignment is the
            # uniform diagonal at that length — one executable per
            # batch bucket, no cross product, no truncation warning
            seq_opts = [(self._ragged_len,) * len(dyn)]
        elif dyn and self.policy.seq_buckets:
            combos = itertools.product(self.policy.seq_buckets,
                                       repeat=len(dyn))
            seq_opts = list(itertools.islice(combos,
                                             self._MAX_SEQ_COMBOS + 1))
            if len(seq_opts) > self._MAX_SEQ_COMBOS:
                import warnings

                n_total = len(self.policy.seq_buckets) ** len(dyn)
                warnings.warn(
                    f"model {self.name!r}: {len(dyn)} dynamic dim-1 "
                    f"feeds × {len(self.policy.seq_buckets)} sequence "
                    f"buckets = {n_total} combinations per batch "
                    f"bucket; warming only the first "
                    f"{self._MAX_SEQ_COMBOS} — the rest run cold "
                    f"on first traffic (use fewer seq buckets, or pad "
                    f"feeds to one length at the caller)")
                seq_opts = seq_opts[:self._MAX_SEQ_COMBOS]
        else:
            seq_opts = [()]
        pairs = [(rows, seqs) for rows in self.policy.batch_buckets
                 for seqs in seq_opts]
        # the slice-back refinement below (warmup()) can only tell a
        # sequence-following output from a constant-width one if every
        # dynamic feed's fed length VARIES across the warmed shapes.  A
        # single sequence bucket (or a combo truncation that pinned one
        # feed) would leave it blind — add one off-bucket probe shape,
        # at the smallest batch bucket, that perturbs every dynamic
        # feed's length.  Costs one extra (never-trafficked) run;
        # without it padded traffic stays rejected (see
        # _validate_and_pad) because slicing would be a guess.  Probe
        # DOWNWARD when possible: every in-bucket traffic length is
        # below the bucket, so bucket-1 is far likelier to run on a
        # length-sensitive model than bucket+1 (and a probe failure is
        # tolerated in warmup(), it just leaves slice-back unverified).
        self._probe_seqs = None
        if dyn and self._dyn_seq_outputs and seq_opts != [()] and any(
                len({t[i] for t in seq_opts}) < 2 for i in range(len(dyn))):
            probe = tuple(v - 1 if v > 1 else v + 1 for v in seq_opts[0])
            self._probe_seqs = probe
            pairs.append((self.policy.batch_buckets[0], probe))
        shapes = []
        for rows, seqs in pairs:
            by_name = dict(zip(dyn, seqs))
            feed = {}
            for n in names:
                var = self._var(n)
                if var is None or var.shape is None:
                    feed = None
                    break
                dims = list(var.shape)
                dims[0] = rows
                if len(dims) >= 2 and dims[1] == -1:
                    if n not in by_name:
                        feed = None
                        break
                    dims[1] = by_name[n]
                if any(d < 0 for d in dims[1:]):
                    feed = None  # non-seq dynamic dim: cannot warm
                    break
                dt = _np_dtype("float32" if var.dtype is None
                               or var.dtype == "" else var.dtype)
                if dt is None:  # unresolvable dtype: cannot warm
                    feed = None
                    break
                feed[n] = np.zeros(dims, dtype=dt)
            if feed:
                shapes.append(feed)
        return shapes

    def warmup(self):
        """Run one batch per bucket shape OUTSIDE the request path (the
        first run of a shape: kernel builds, allocator growth).  Returns
        the number of bucket shapes warmed."""
        warmed = 0
        out_widths = collections.defaultdict(set)
        seqs_fed = set()
        skipped_mixed = []
        for feed in self._warmup_shapes():
            # Engine.warmup()'s closed check releases the engine lock
            # before reaching the lane, so a concurrent close() could
            # otherwise leave this loop running the whole bucket cross
            # product for a dead engine — re-check per shape
            if self._closed:
                raise ServingOverloadError(
                    f"model {self.name!r}: engine closed during warmup",
                    reason="closed")
            fut = concurrent.futures.Future()
            rows = next(iter(feed.values())).shape[0]
            key = tuple((n, tuple(a.shape[1:]), str(a.dtype))
                        for n, a in feed.items())
            req = Request(feed, rows, "__warmup__", fut, key)
            self._execute([req], warmup=True)
            seqs = tuple(int(feed[n].shape[1])
                         for n in self._dyn_seq_inputs)
            try:
                out = fut.result()
            except (KeyboardInterrupt, SystemExit):
                raise
            except Exception:
                # the PROBE shape is synthetic (an off-bucket length no
                # traffic ever takes): a length-sensitive model failing
                # it must not make the real bucket set unwarmable —
                # skip it, but say that slice-back stays unverified, so
                # padded dyn-output traffic keeps rejecting typed.
                if seqs and seqs == self._probe_seqs:
                    import warnings

                    warnings.warn(
                        f"model {self.name!r}: the off-bucket probe "
                        f"shape (seq lengths {seqs}) failed to "
                        f"run, so warmup could not verify which "
                        f"dynamic-length outputs track the fed "
                        f"sequence length — padded requests will be "
                        f"rejected; pad feeds to a bucket length at "
                        f"the caller, or re-export with static output "
                        f"widths")
                    continue
                # a UNIFORM assignment (every dynamic feed at one
                # length) failing means the model itself is broken:
                # propagate loudly.  A MIXED assignment may simply
                # violate the model's own contract (elementwise ops
                # need equal lengths) — such traffic would fail at
                # request time with the error fanned to that future
                # anyway, so skip the shape and say so, rather than
                # making every equal-length-contract model unwarmable.
                if len(set(seqs)) <= 1:
                    raise
                skipped_mixed.append(seqs)
                continue
            seqs_fed.add(seqs)
            for n, a in out.items():
                if n in self._dyn_seq_outputs and a.ndim >= 2:
                    out_widths[n].add(int(a.shape[1]))
            # the synthetic off-bucket probe still feeds the width
            # observation above but is NOT a bucket shape: the returned
            # count must stay one-per-bucket-shape (ops scripts assert
            # warmed == expected bucket count), and stats() excludes
            # its executable from warm_executables for the same reason
            if seqs and seqs == self._probe_seqs:
                with self._cv:  # stats() iterates this set too
                    self._probe_keys.add((self.policy.batch_bucket(rows),
                                          key))
            else:
                warmed += 1
        if skipped_mixed:
            import warnings

            warnings.warn(
                f"model {self.name!r}: {len(skipped_mixed)} mixed "
                f"sequence-bucket assignment(s) failed to warm "
                f"(e.g. {skipped_mixed[0]}) and were skipped — the "
                f"model likely requires equal dynamic lengths; "
                f"requests mixing those lengths will fail at request "
                f"time")
        # empirical refinement of the declared dynamic-dim-1 output set:
        # a dynamic-DECLARED output whose width stayed CONSTANT while the
        # fed sequence buckets varied does not actually follow the
        # sequence — slicing it back by width match would silently
        # truncate real columns whenever its constant width coincides
        # with a padded length.  Only valid when EVERY dynamic feed's
        # length varied (an output tracking a never-varied feed would
        # look constant and be wrongly exempted); _warmup_shapes adds a
        # probe shape to guarantee that.  (Atomic rebinds: submit
        # threads read both attributes unlocked.)
        if len(seqs_fed) > 1 and all(
                len({t[i] for t in seqs_fed}) > 1
                for i in range(len(self._dyn_seq_inputs))):
            self._dyn_seq_outputs = {
                n for n in self._dyn_seq_outputs
                if len(out_widths.get(n, ())) != 1}
            self._seq_outputs_confirmed = True
        return warmed

    # -- lifecycle / stats -------------------------------------------------

    def drain(self):
        """Graceful drain: stop admission — new submits reject typed with
        ``reason="draining"`` — and fail the QUEUED futures typed; the
        batch already in flight on the scheduler thread completes and
        resolves normally.  The scheduler stays alive (close() still
        owns teardown).  Idempotent."""
        with self._cv:
            if self._closed or self._draining:
                return
            self._draining = True
            leftovers, self._queue = list(self._queue), collections.deque()
            self._queued_rows.clear()
            self._queue_depth.set(0)
            self._cv.notify_all()
        for r in leftovers:
            if r.future.set_running_or_notify_cancel():
                self._rejected["draining"].inc()
                r.future.set_exception(ServingOverloadError(
                    f"model {self.name!r}: engine drained before the "
                    f"request was scheduled — resubmit to another "
                    f"replica", reason="draining"))

    def close(self):
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=5)
        # a never-started (or wedged) lane may still hold queued
        # requests: fail their futures typed instead of leaving callers
        # blocked forever
        with self._cv:
            leftovers, self._queue = list(self._queue), collections.deque()
            self._queued_rows.clear()
            self._queue_depth.set(0)
        for r in leftovers:
            if r.future.set_running_or_notify_cancel():
                r.future.set_exception(ServingOverloadError(
                    f"model {self.name!r}: engine closed before the "
                    f"request was scheduled", reason="closed"))

    def stats(self):
        from paddle_tpu_torch import observability as obs

        self._check_metrics_epoch()
        with self._cv:
            depth = len(self._queue)
            # copy under the lock: submit() inserts first-seen tenant
            # keys while holding _cv, and _execute/warmup add warm exec
            # keys under _cv — an unlocked dict()/set-subtraction here
            # can raise mid-iteration
            tenants = dict(self._tenant_requests)
            n_warm = len(self._warm - self._probe_keys)
        # lane-local counts, NOT the process-cumulative registry: a
        # fresh engine must not inherit a closed predecessor's figures
        cache = {k: int(self._cache_counts.get(k, 0))
                 for k in ("warmup", "warm", "cold")}
        dispatched = cache["warm"] + cache["cold"]

        def delta_quantiles(child, baseline):
            """Lane-local p50/p99 of a process-cumulative histogram: the
            delta against the bind-time baseline, so a fresh lane never
            inherits a closed predecessor's figures."""
            cur = child.hist_data()
            h = {"buckets": [(le, c - b) for (le, c), (_, b) in
                             zip(cur["buckets"], baseline["buckets"])],
                 "sum": cur["sum"] - baseline["sum"],
                 "count": cur["count"] - baseline["count"]}
            if h["count"] <= 0:
                return {}
            return {"p50": obs.hist_quantile(h, 0.50),
                    "p99": obs.hist_quantile(h, 0.99),
                    "count": h["count"]}

        return {
            "signature": self.signature,
            "queue_depth": depth,
            "draining": self._draining,
            "requests": self._served_requests,
            "batches": self._served_batches,
            "warmup_batches": self._warmup_batches,
            "warm_executables": n_warm,
            "executable_cache": dict(
                cache, hit_rate=(cache["warm"] / dispatched
                                 if dispatched else None)),
            "tenants": tenants,
            "latency_seconds": delta_quantiles(self._lat,
                                               self._lat_baseline),
            # the latency split: queue_wait = submit -> batch formation,
            # execute = batch formation -> resolve
            "queue_wait_seconds": delta_quantiles(
                self._queue_wait, self._queue_wait_baseline),
            "execute_seconds": delta_quantiles(
                self._execute_hist, self._execute_baseline),
        }


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------


class Engine:
    """Request path over N `AnalysisPredictor`s.

    ``models`` maps a serving name to a saved-model dir, an
    `AnalysisConfig`, or an already-built `AnalysisPredictor`.  Requests
    are dicts of numpy arrays with a leading row dim; `submit` returns a
    future resolving to ``{output_name: array[rows, ...]}``; `infer` is
    the blocking form.  Recommended lifecycle: build with
    ``auto_start=False`` → `warmup()` (one run per bucket shape outside
    the request path) → `start()` → traffic → `close()`.  `warmup()` on
    an already-started engine is safe (a per-lane lock serializes it
    against scheduler dispatch).

    ``place``: the device every model loaded from a directory runs on
    (CUDAPlace(0) when None; without a GPU the caller must pass
    CPUPlace()).  An `AnalysisConfig` keeps its own device choice and a
    built `AnalysisPredictor` its own device.
    """

    def __init__(self, models=None, batch_buckets=None, seq_buckets=None,
                 max_wait_ms=None, max_queue=None, name="engine",
                 auto_start=True, deadline_ms=None, place=None):
        from paddle_tpu_torch.fluid import flags as _flags
        from paddle_tpu_torch.fluid.framework import resolve_place

        self.place = resolve_place(place)  # first: no GPU and no place raises
        self.name = name
        self.policy = BucketPolicy(batch_buckets, seq_buckets)
        self._max_wait_s = (
            _flags.flag("serving_batch_timeout_ms")
            if max_wait_ms is None else max_wait_ms) / 1000.0
        self._max_queue = int(_flags.flag("serving_max_queue")
                              if max_queue is None else max_queue)
        if self._max_queue < 1:
            raise ValueError("max_queue must be >= 1")
        # per-request deadline (0 = off): queued or in-flight requests
        # past it resolve ServingDeadlineError instead of waiting forever
        self._deadline_s = (
            _flags.flag("serving_deadline_ms")
            if deadline_ms is None else deadline_ms) / 1000.0
        self._lanes = {}
        # serializes lane-map mutation against lifecycle transitions and
        # snapshots: load_model() from one thread must not race a
        # concurrent close()/start()/stats() iterating the map (a stats
        # scrape runs on the exposition server's handler thread)
        self._lock = threading.Lock()
        self._started = False
        self._closed = False
        try:
            for mname, model in (models or {}).items():
                self.load_model(mname, model)
            from . import status as _status

            # inside the cleanup block: register_page('/servez') raises
            # when another subsystem owns the path
            _status.track_engine(self)
            # auto_start inside the cleanup block: a scheduler thread
            # that fails to spawn (process thread limit) must not leak
            # the built lanes
            if auto_start:
                self.start()
        except BaseException:
            # the caller never gets an engine reference to close(): shut
            # the already-built lanes down here instead of leaking them
            self.close()
            raise

    # -- model management --------------------------------------------------

    def load_model(self, name, model, ragged=None):
        """Load a model under a serving name.  `model`: saved-model dir
        (str, served on the engine's place), `AnalysisConfig`, or a
        built `AnalysisPredictor`.

        ``ragged`` (default: FLAGS_ragged_attention) puts the lane in
        ragged mode — every dynamic dim-1 feed pads to the single
        largest sequence bucket so mixed-length traffic shares one
        shape key (and one batch), and warmup runs one shape
        per batch bucket instead of the seq-bucket cross product.  The
        model must mask its own padded tail from a per-row lengths feed
        (layers.ragged_attention; docs/KERNELS.md)."""
        from paddle_tpu_torch.fluid import flags as _flags
        from paddle_tpu_torch.inference import (AnalysisConfig,
                                                AnalysisPredictor,
                                                create_paddle_predictor)

        if ragged is None:
            ragged = bool(_flags.flag("ragged_attention"))

        if self._closed:
            raise ServingOverloadError(
                f"engine {self.name!r} is closed; cannot load models",
                reason="closed")
        if name in self._lanes:
            raise ValueError(f"model {name!r} already loaded")
        if isinstance(model, str):
            predictor = create_paddle_predictor(AnalysisConfig(model),
                                                place=self.place)
        elif isinstance(model, AnalysisConfig):
            predictor = create_paddle_predictor(model)
        elif isinstance(model, AnalysisPredictor):
            predictor = model
        else:
            raise TypeError(
                f"model must be a dir, AnalysisConfig or "
                f"AnalysisPredictor; got {type(model).__name__}")
        lane = _ModelLane(name, predictor, self.policy, self._max_wait_s,
                          self._max_queue, deadline_s=self._deadline_s,
                          ragged=ragged)
        # pt_serve_* series are keyed by model name: a second engine of
        # this process serving the same name would alias its series (and
        # /servez stats) onto this one — warn, don't corrupt silently
        from . import status as _status

        for other in _status.live_engines():
            if other is not self and name in getattr(other, "_lanes", {}):
                import warnings

                warnings.warn(
                    f"model name {name!r} is already served by engine "
                    f"{other.name!r} in this process; pt_serve_* metrics "
                    f"and /servez stats for the two will alias — use "
                    f"distinct model names")
        with self._lock:
            # re-check under the lock: a close() between the cheap early
            # guard and here must not end with a live lane on a dead
            # engine (the lane has no threads yet, so discarding is safe)
            if self._closed:
                raise ServingOverloadError(
                    f"engine {self.name!r} is closed; cannot load models",
                    reason="closed")
            if name in self._lanes:
                raise ValueError(f"model {name!r} already loaded")
            self._lanes[name] = lane
            started = self._started
        if started:
            lane.start()
        return lane.signature

    def models(self):
        with self._lock:
            return sorted(self._lanes)

    def _lane(self, model):
        lane = self._lanes.get(model)
        if lane is None:
            raise ModelNotLoadedError(
                f"model {model!r} not loaded; serving {self.models()}")
        return lane

    # -- lifecycle ---------------------------------------------------------

    def start(self):
        """Start the per-model scheduler threads.  Submissions before
        start() queue up (admission control still applies)."""
        with self._lock:
            if self._closed:
                raise ServingOverloadError(
                    f"engine {self.name!r} is closed; cannot start",
                    reason="closed")
            self._started = True
            lanes = list(self._lanes.values())
        for lane in lanes:
            lane.start()
        return self

    def warmup(self, model=None):
        """Run every bucket shape once (all models, or one).  Returns
        {model: n_shapes_warmed}."""
        with self._lock:
            if self._closed:
                raise ServingOverloadError(
                    f"engine {self.name!r} is closed; cannot warm up",
                    reason="closed")
            if model is None:
                lanes = list(self._lanes.values())
            elif model in self._lanes:
                lanes = [self._lanes[model]]
            else:
                lanes = None
        if lanes is None:
            raise ModelNotLoadedError(
                f"model {model!r} not loaded; serving {self.models()}")
        return {lane.name: lane.warmup() for lane in lanes}

    def drain(self):
        """Graceful drain across every lane: admission stops typed
        (``reason="draining"``), queued futures fail typed, in-flight
        batches complete.  The engine stays open until close()."""
        with self._lock:
            lanes = list(self._lanes.values())
        for lane in lanes:
            lane.drain()

    def close(self):
        with self._lock:
            if self._closed:
                return
            self._closed = True
            lanes = list(self._lanes.values())
        for lane in lanes:
            lane.close()
        from . import status as _status

        _status.untrack_engine(self)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- request path ------------------------------------------------------

    def submit(self, model, feed, tenant="default"):
        """Enqueue one request; returns a `concurrent.futures.Future`
        resolving to ``{output_name: array[rows, ...]}`` (this caller's
        rows only — batching is invisible).  Raises
        `ServingOverloadError` at the admission limit and
        `FeedValidationError` on a bad feed."""
        # a closed engine's lanes reject with reason="closed" — routed
        # through the lane so the rejection is booked per model
        return self._lane(model).submit(feed, tenant)

    def infer(self, model, feed, tenant="default", timeout=None):
        """Blocking convenience: submit + wait."""
        return self.submit(model, feed, tenant=tenant).result(
            timeout=timeout)

    # -- introspection -----------------------------------------------------

    def stats(self):
        """Bucket policy and per-model queue / served / cache-hit-rate /
        tenant / latency figures (the JAX engine's /servez payload)."""
        with self._lock:
            lanes = sorted(self._lanes.items())
        return {
            "engine": self.name,
            "started": self._started,
            "place": repr(self.place),
            "buckets": self.policy.describe(),
            "batch_timeout_ms": self._max_wait_s * 1000.0,
            "max_queue": self._max_queue,
            "models": {name: lane.stats() for name, lane in lanes},
        }
