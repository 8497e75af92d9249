"""Data-parallel execution: the transpiler and a single-process replica
runner (counterpart of ``paddle_tpu/parallel/data_parallel.py``).

:func:`transpile_data_parallel` is the JAX package's rewrite, op for op
(the reference's multi_devices_graph_pass): the loss-gradient seed
becomes 1/n; every raw parameter gradient gets a ``c_allreduce_sum``
after its producer, or, with ``quant_grads``, same-dtype gradients
coalesce into buckets of up to ``FLAGS_fuse_grad_size_in_MB`` that take
one block-scaled int8 collective each, emitted in ready order; and where
every member of a bucket feeds exactly one sgd / momentum / adam / adamw
op, the bucket keeps its wire format (``c_allreduce_quant_keep``) and
each optimizer op becomes its fused form, which runs K8
(kernels/fused_update.py).  It records the same four reports on the
program (``_collective_bytes_per_step``, ``_quant_allreduce_plan``,
``_overlap_schedule``, ``_fused_update_bytes_saved``).

:class:`DataParallelRunner` runs the transpiled program over a
ReplicaGroup (parallel/mesh.py): one process drives n replicas in
lockstep, as the JAX package's one ``shard_map`` program drives the
devices of its mesh.  Each op runs once a replica on that replica's
batch shard; a collective runs once over every replica's value
(fluid/executor.py ``run_plan``).  What the runner keeps:

- **Replica state.** Every replica has its own copy of each
  persistable the program reads (parameters, moments, beta powers, the
  learning rate), because the optimizer ops update them in place.
  Replica 0 uses the scope's own tensors; the others get copies once,
  like the reference's BCastParamsToDevices, and again only for a name
  whose scope tensor was replaced, or written in place (its version
  counter moved), since the runner last left it.
  After a step replica 0's values are the scope's.  All replicas apply
  the same update to the same reduced gradient, so they stay
  bit-identical.
- **Feeds** split on dim 0 into n equal shards (an indivisible batch
  raises ``ValueError``); fetches concatenate on dim 0, a scalar fetch
  becoming an [n] vector of the replicas' values.
- **Random streams.** Replica r's run stream is seeded from the run
  seed and r, and a seeded op folds r into its own stream
  (ops/common.py ``op_generator``), as the JAX package folds the mesh
  axis index into every op key: each batch shard draws its own dropout
  masks.
- **The captured step.** With every replica on one CUDA card and an
  executor that captures (fluid/executor.py), the whole lockstep
  ``run_plan`` over the replicas' envs — the forward and backward of
  every replica, the quantized all-reduce in plain PyTorch and K8's
  group launches — is captured once per signature and scope as one
  CUDA graph after an eager warm-up step, and replayed on every later
  step: the runner keeps an ``executor._Signature`` of the group a
  signature and is its scope binding (``values``, ``adopt``,
  ``left``).  The replicas' tensors are the graph's storage: a
  scope tensor replaced or edited in place since the last step is
  copied into them (a replay moves no version counter, so a moved one
  is a user's edit), and the scope keeps replica 0's tensors.  Replicas
  on several cards run the eager loop by rule.

Each step books the executor's metrics under ``path="dp"``
(``pt_compile_cache_total``, ``pt_step_seconds``, ``pt_examples_total``
and the step phases).  Not ported: the GSPMD lane and the health
sentinel (the runner raises when either is asked for), the autotune
pin and ``cost_analysis``.
"""

from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch.fluid import executor as ex
from paddle_tpu_torch.fluid.framework import (Operator, Variable,
                                              grad_var_name)
from . import mesh as pmesh

__all__ = ["DataParallelRunner", "transpile_data_parallel",
           "collective_payload_counter", "overlap_buckets_counter",
           "fused_update_bytes_counter"]


def collective_payload_counter():
    from paddle_tpu_torch.observability import metrics as obs

    return obs.counter(
        "pt_collective_payload_bytes_total",
        "Estimated per-replica payload moved by gradient/BN collectives "
        "(both phases counted; static shapes only)",
        labels=("collective",))


def overlap_buckets_counter():
    from paddle_tpu_torch.observability import metrics as obs

    return obs.counter(
        "pt_overlap_buckets_ready_total",
        "Gradient buckets dispatched in ready order (overlap with "
        "backward compute) per step")


def fused_update_bytes_counter():
    from paddle_tpu_torch.observability import metrics as obs

    return obs.counter(
        "pt_fused_update_bytes_saved_total",
        "Modeled fp32 device-memory round-trip bytes avoided by fused "
        "dequant->optimizer-update->requant step kernels")


# optimizer ops the fused-update rewrite absorbs
_FUSED_UPDATE_OPS = {"sgd": "fused_sgd_quant_grad",
                     "adam": "fused_adam_quant_grad",
                     "adamw": "fused_adamw_quant_grad",
                     "lamb": "fused_lamb_quant_grad",
                     "momentum": "fused_momentum_quant_grad"}


def _plan_quant_buckets(block, grads, prod_index, block_size, bucket_mb):
    """Group same-dtype grads, in production order, into buckets of at
    most ``bucket_mb`` MB.  Returns (buckets, leftovers): grads without a
    static float shape stay out."""
    cap_bytes = max(1, int(float(bucket_mb) * (1 << 20)))
    eligible, leftovers = [], []
    for g in sorted(grads, key=lambda g: prod_index[g]):
        v = block._find_var_recursive(g)
        shape = tuple(v.shape) if (v is not None and v.shape) else None
        dtype = v.dtype if v is not None else None
        if (shape is None or any(d is None or d < 0 for d in shape)
                or dtype not in ("float32", "float16", "bfloat16")):
            leftovers.append(g)
            continue
        eligible.append((g, shape, dtype))

    itemsize = {"float32": 4, "float16": 2, "bfloat16": 2}
    buckets = []
    open_by_dtype = {}
    for g, shape, dtype in eligible:
        nbytes = int(np.prod(shape)) * itemsize[dtype]
        b = open_by_dtype.get(dtype)
        if b is None or b["bytes"] + nbytes > cap_bytes:
            b = {"grads": [], "shapes": [], "dtype": dtype, "bytes": 0,
                 "insert_at": -1}
            buckets.append(b)
            open_by_dtype[dtype] = b
        b["grads"].append(g)
        b["shapes"].append(list(shape))
        b["bytes"] += nbytes
        b["insert_at"] = max(b["insert_at"], prod_index[g])
    return buckets, leftovers


def _plan_fused_updates(block, buckets, block_size):
    """A bucket keeps the wire format when every member gradient has
    exactly one consumer, an optimizer op of ``_FUSED_UPDATE_OPS`` taking
    it as ``Grad``, and block alignment would not double the payload.
    Returns {id(optimizer op): (bucket, grad)} and stamps qualifying
    buckets with their members' block offsets."""
    member = {g: b for b in buckets for g in b["grads"]}
    consumers = {}
    for op in block.ops:
        for g in set(op.input_arg_names):
            if g in member:
                consumers.setdefault(g, []).append(op)
    rewrites = {}
    bs_q = int(block_size)
    for b in buckets:
        ops_for = []
        for g in b["grads"]:
            cons = consumers.get(g, [])
            if (len(cons) == 1 and cons[0].type in _FUSED_UPDATE_OPS
                    and cons[0].inputs.get("Grad") == [g]):
                ops_for.append(cons[0])
            else:
                ops_for = None
                break
        if not ops_for:
            continue
        off, offsets = 0, []
        for s in b["shapes"]:
            offsets.append(off // bs_q)
            numel = int(np.prod(s))
            off += numel + (-numel) % bs_q
        raw = sum(int(np.prod(s)) for s in b["shapes"])
        if off > 2 * raw:
            continue
        b["fused_update"] = True
        b["offsets"], b["aligned_elems"] = offsets, off
        for g, op in zip(b["grads"], ops_for):
            rewrites[id(op)] = (b, g)
    return rewrites


def _create_bucket_vars(block, buckets, num_devices, block_size,
                        quant_algo, quant_crossover_kb):
    """Resolve each bucket's algorithm once (the emission, the wire-bytes
    model and the q-var shapes all read it) and create the fused buffer
    and, for fused-update buckets, the kept wire image's vars at the
    padded shapes the lowering returns."""
    from paddle_tpu_torch.kernels import quantized_collectives as qc
    from paddle_tpu_torch.kernels.ring_collectives import (
        select_allreduce_algo)

    bs_q = int(block_size)
    for k, b in enumerate(buckets):
        b["elements"] = (b["aligned_elems"] if b.get("fused_update")
                         else sum(int(np.prod(s)) for s in b["shapes"]))
        b["algo"] = select_allreduce_algo(
            b["elements"], num_devices, algo=quant_algo,
            crossover_kb=quant_crossover_kb, block_size=bs_q)
        b["fused"] = block.create_var(
            name=f"@FUSED_GRAD_QUANT@_{b['dtype']}_{k}",
            dtype=b["dtype"], shape=[b["elements"]])
        if b.get("fused_update"):
            padded = qc.quant_padded_elems(b["elements"], num_devices,
                                           bs_q, algo=b["algo"])
            base = f"@FUSED_GRAD_QUANT@_{b['dtype']}_{k}"
            b["qhi"] = block.create_var(name=base + "@QHI", dtype="int8",
                                        shape=[padded])
            b["qlo"] = block.create_var(name=base + "@QLO", dtype="int8",
                                        shape=[padded])
            b["qsc"] = block.create_var(name=base + "@QSCALE",
                                        dtype="float32",
                                        shape=[padded // bs_q])


def _make_fused_update_op(block, op, b, g, block_size):
    """One optimizer op rewritten to its fused form: ``Grad`` becomes
    the bucket's wire image plus the member's block offset and size."""
    i = b["grads"].index(g)
    inputs = {slot: list(names) for slot, names in op.inputs.items()
              if slot != "Grad"}
    inputs["QHi"] = [b["qhi"].name]
    inputs["QLo"] = [b["qlo"].name]
    inputs["QScale"] = [b["qsc"].name]
    attrs = dict(op.attrs)
    attrs.update(offset_blocks=int(b["offsets"][i]),
                 numel=int(np.prod(b["shapes"][i])),
                 block_size=int(block_size))
    return Operator(block, _FUSED_UPDATE_OPS[op.type], inputs=inputs,
                    outputs={s: list(n) for s, n in op.outputs.items()},
                    attrs=attrs)


def transpile_data_parallel(program, loss_name, num_devices,
                            gradient_scale="coeff_num_device",
                            sync_batch_norm_stats=True,
                            quant_grads=False, quant_block_size=None,
                            quant_bucket_mb=None, quant_algo=None,
                            quant_crossover_kb=None, overlap=None,
                            fused_update=None):
    """Rewrite ``program`` in place for data-parallel execution over
    ``num_devices`` replicas: the JAX package's transpile, op for op
    (see the module docstring; the knobs default to their flags)."""
    block = program.global_block()
    if loss_name is not None and gradient_scale == "coeff_num_device":
        seed_name = grad_var_name(loss_name)
        for op in block.ops:
            if op.type == "fill_constant" and seed_name in op.output_arg_names:
                op.attrs["value"] = float(op.attrs.get("value", 1.0)) / num_devices

    raw_grads = {g for _, g in getattr(program, "_params_grads", [])}
    if not raw_grads:  # fallback: grads feeding optimizer ops directly
        raw_grads = {op.inputs["Grad"][0] for op in block.ops
                     if op.attrs.get("op_role") == "optimize" and "Grad" in op.inputs}
    dgc_map = getattr(program, "_dgc_encoded", {})
    dgc_encoded = set(dgc_map.values())
    raw_grads = {dgc_map.get(g, g) for g in raw_grads}

    from paddle_tpu_torch.fluid import flags as _flags

    if overlap is None:
        overlap = _flags.flag("overlap_allreduce")
    overlap = bool(overlap)
    if fused_update is None:
        fused_update = _flags.flag("fused_update")
    fused_update = bool(fused_update)

    # producer indices against the original op list; the backward span
    prod_index = {}
    backward_start = None
    for i, op in enumerate(block.ops):
        if backward_start is None and any(
                "@GRAD" in n for n in op.output_arg_names):
            backward_start = i
        for g in raw_grads.intersection(op.output_arg_names):
            prod_index[g] = i  # last producer wins
    backward_end = max(prod_index.values()) if prod_index else -1
    if backward_start is None or backward_start > backward_end:
        backward_start = 0

    buckets, bucketed = [], {}
    fused_rewrites = {}  # id(optimizer op) -> (bucket, grad name)
    if quant_grads:
        if quant_block_size is None:
            quant_block_size = _flags.flag("quant_allreduce_block_size")
        if quant_bucket_mb is None:
            quant_bucket_mb = _flags.flag("fuse_grad_size_in_MB")
        if quant_algo is None:
            quant_algo = _flags.flag("quant_allreduce_algo")
        if quant_crossover_kb is None:
            quant_crossover_kb = _flags.flag("quant_allreduce_crossover_kb")
        candidates = {g for g in raw_grads
                      if g in prod_index and g not in dgc_encoded}
        buckets, _left = _plan_quant_buckets(
            block, candidates, prod_index, quant_block_size,
            quant_bucket_mb)
        for b in buckets:
            for g in b["grads"]:
                bucketed[g] = b
        if fused_update and num_devices > 1:
            fused_rewrites = _plan_fused_updates(block, buckets,
                                                 quant_block_size)
        _create_bucket_vars(block, buckets, num_devices, quant_block_size,
                            quant_algo, quant_crossover_kb)

    collective_bytes = {"c_allreduce_sum": 0, "c_allreduce_quant": 0,
                        "c_allreduce_avg": 0}
    _itemsize = {"float32": 4, "float16": 2, "bfloat16": 2, "float64": 8}

    def _static_bytes(name):
        v = block._find_var_recursive(name)
        if v is None or not v.shape or any(
                d is None or d < 0 for d in v.shape):
            return 0
        return int(np.prod(v.shape)) * _itemsize.get(v.dtype, 4)

    quant_plan = {"block_size": int(quant_block_size or 0),
                  "algo": quant_algo, "crossover_kb": quant_crossover_kb,
                  "buckets": []}
    schedule = {"enabled": overlap, "backward_start": backward_start,
                "backward_end": backward_end, "buckets": []}
    bwd_span = max(1, backward_end - backward_start)
    fused_saved_bytes = 0

    def _emit_bucket(b, out, insert_at):
        from paddle_tpu_torch.kernels import fused_update as fu
        from paddle_tpu_torch.kernels import quantized_collectives as qc

        nonlocal fused_saved_bytes
        fused = b["fused"].name
        n_elems, algo = b["elements"], b["algo"]
        is_fused = bool(b.get("fused_update"))
        out.append(Operator(
            block, "coalesce_tensor",
            inputs={"Input": list(b["grads"])},
            outputs={"FusedOutput": [fused]},
            attrs={"dtype": b["dtype"], "op_role": "backward",
                   **({"align": int(quant_block_size)} if is_fused
                      else {})}))
        if is_fused:
            out.append(Operator(
                block, "c_allreduce_quant_keep",
                inputs={"X": [fused]},
                outputs={"QHi": [b["qhi"].name], "QLo": [b["qlo"].name],
                         "QScale": [b["qsc"].name]},
                attrs={"ring_id": 0, "use_calc_stream": True,
                       "block_size": int(quant_block_size),
                       "algo": algo, "op_role": "backward"}))
            fused_saved_bytes += fu.bytes_saved(n_elems)
        else:
            out.append(Operator(
                block, "c_allreduce_quant",
                inputs={"X": [fused]}, outputs={"Out": [fused]},
                attrs={"ring_id": 0, "use_calc_stream": True,
                       "block_size": int(quant_block_size),
                       "algo": algo, "op_role": "backward"}))
            out.append(Operator(
                block, "uncoalesce_tensor",
                inputs={"X": [fused]}, outputs={"Out": list(b["grads"])},
                attrs={"shapes": [list(s) for s in b["shapes"]],
                       "op_role": "backward"}))
        collective_bytes["c_allreduce_quant"] += qc.wire_bytes(
            n_elems, block_size=int(quant_block_size),
            n_devices=num_devices, algo=algo)
        quant_plan["buckets"].append({"elements": n_elems, "algo": algo,
                                      "fused_update": is_fused})
        schedule["buckets"].append({
            "elements": n_elems, "algo": algo, "fused_update": is_fused,
            "insert_at": insert_at,
            "ready_frac": round(min(1.0, max(
                0.0, (insert_at - backward_start) / bwd_span)), 4)
            if backward_end >= 0 else 1.0})

    new_ops = []
    deferred = []  # collectives held back until after the full backward
    pending = set(raw_grads)
    for op_idx, op in enumerate(block.ops):
        if id(op) in fused_rewrites:
            b, g = fused_rewrites[id(op)]
            new_ops.append(_make_fused_update_op(block, op, b, g,
                                                 quant_block_size))
            continue
        new_ops.append(op)
        produced = pending.intersection(op.output_arg_names)
        for g in produced:
            pending.discard(g)
            if g in bucketed:
                continue  # fused collective emitted at the bucket boundary
            ar = Operator(
                block, "c_allreduce_sum",
                inputs={"X": [g]}, outputs={"Out": [g]},
                attrs={"ring_id": 0, "use_calc_stream": True,
                       "op_role": "backward"})
            (new_ops if overlap else deferred).append(ar)
            collective_bytes["c_allreduce_sum"] += 2 * _static_bytes(g)
        for b in buckets:
            if b["insert_at"] == op_idx:
                _emit_bucket(b, new_ops if overlap else deferred,
                             op_idx if overlap else backward_end)
        if not overlap and op_idx == backward_end and deferred:
            new_ops.extend(deferred)
            deferred = []
        if sync_batch_norm_stats and op.type == "batch_norm" and not op.attrs.get("is_test"):
            for slot in ("MeanOut", "VarianceOut"):
                names = op.outputs.get(slot, [])
                if names:
                    new_ops.append(Operator(
                        block, "c_allreduce_avg",
                        inputs={"X": [names[0]]}, outputs={"Out": [names[0]]},
                        attrs={"ring_id": 0, "op_role": "forward"}))
                    collective_bytes["c_allreduce_avg"] += \
                        2 * _static_bytes(names[0])
    block.ops = new_ops
    if num_devices <= 1:
        collective_bytes = {k: 0 for k in collective_bytes}
        fused_saved_bytes = 0
    program._collective_bytes_per_step = collective_bytes
    program._quant_allreduce_plan = quant_plan if quant_grads else None
    program._overlap_schedule = schedule if quant_grads else None
    program._fused_update_bytes_saved = fused_saved_bytes
    program._bump_version()
    return program


class DataParallelRunner:
    """Transpiles a program and runs it over one replica a place (see
    the module docstring).  ``places`` None means one replica a CUDA
    card.  Each knob (quant all-reduce, its algorithm, overlap, the
    fused update, the GSPMD lane) is ``build_strategy``'s, or its flag's
    where the strategy leaves it None."""

    def __init__(self, program, loss_name, build_strategy=None, places=None):
        from paddle_tpu_torch import passes as _graph_passes
        from paddle_tpu_torch.fluid import flags as _flags
        from paddle_tpu_torch.fluid.framework import CUDAPlace

        if places is None:
            places = [CUDAPlace(i) for i in range(torch.cuda.device_count())]
        self.group = pmesh.ReplicaGroup(places)
        n = self.num_devices = self.group.size

        def knob(name, flag=False):
            """The strategy's value; with ``flag``, None defers to the
            flag of the same name."""
            v = getattr(build_strategy, name, None)
            return _flags.flag(name) if v is None and flag else v

        if knob("gspmd_executor", flag=True):
            raise NotImplementedError(
                "the GSPMD lane (gspmd_executor) is not ported to "
                "paddle_tpu_torch")
        if _flags.flag("health_sentinel"):
            raise NotImplementedError(
                "the health sentinel (FLAGS_health_sentinel) is not ported "
                "to paddle_tpu_torch")
        self.quant_grads = bool(knob("quant_allreduce", flag=True))
        # graph passes before the transpile, so the bucket and
        # fused-update scans see the final forward graph
        _graph_passes.apply_graph_passes(program, lane="dp")
        # the transpile reads the flags where these are None
        self.program = transpile_data_parallel(
            program, loss_name, n,
            sync_batch_norm_stats=knob("sync_batch_norm") is not False,
            quant_grads=self.quant_grads,
            quant_algo=knob("quant_allreduce_algo"),
            overlap=knob("overlap_allreduce"),
            fused_update=knob("fused_update"))
        self._plans = {}
        self._entries = {}    # key -> executor._Signature of the group
        self._pins = {}       # key -> the scope whose id it holds
        self._replicas = {}   # name -> [tensor of each replica]
        # name -> (scope tensor, its version) as the runner last left it
        self._written = {}
        self.label = f"dp_block@{id(self):x}"

    # -- replica state: the binding of the group's executor._Signature --
    def _fresh(self, scope, name):
        """Whether the scope's ``name`` is the tensor the runner left
        there, unwritten since."""
        t, seen = scope.get(name), self._written.get(name)
        return seen is not None and seen[0] is t and seen[1] == t._version

    def values(self, scope, names):
        """Each replica's copy of the scope's ``names``: made on first
        use and again when the scope's tensor is not the one the runner
        left there, or was written in place since (a plain run on the
        same scope, an in-place edit of the learning rate)."""
        for name in names:
            if not self._fresh(scope, name):
                t = scope.get(name)
                self._replicas[name] = [t.to(dev, copy=r > 0)
                                        for r, dev in enumerate(
                                            self.group.devices)]
                self._written[name] = (t, t._version)
        return [{n: self._replicas[n][r] for n in names}
                for r in range(self.num_devices)]

    def adopt(self, scope, inputs):
        """Before a replay: a scope tensor that is not the graph's
        replica 0 input, or was written in place since the runner left
        it (a replay moves no version counter, so a moved one is a
        user's edit), is copied into every replica's input tensor (the
        graph's storage, ``inputs`` a dict a replica), and the scope
        takes replica 0's back.  False when one no longer fits (the
        step is captured again)."""
        for name in inputs[0]:
            have = [inp[name] for inp in inputs]
            t = scope.get(name)
            if not (t is have[0] and self._fresh(scope, name)):
                if not all(ex._same_storage_shape(t, h) for h in have):
                    return False
                for h in have:
                    if h is not t:
                        h.copy_(t)
                scope.set(name, have[0])
            self._replicas[name] = have
            self._written[name] = (have[0], have[0]._version)
        return True

    def left(self, scope, names, values):
        """Record ``values`` (a dict a replica) as the replicas' tensors
        of ``names``, replica 0's as the scope's."""
        for name in names:
            vals = [v[name] for v in values]
            self._replicas[name] = vals
            scope.set(name, vals[0])
            self._written[name] = (vals[0], vals[0]._version)

    def _split_feed(self, executor, feed):
        n = self.num_devices
        for k, v in feed.items():
            if np.shape(v) and np.shape(v)[0] % n != 0:
                raise ValueError(
                    f"feed {k!r} batch {np.shape(v)[0]} not divisible by "
                    f"{n} devices")
        shards = [{} for _ in range(n)]
        for k, v in feed.items():
            rows = np.shape(v)[0] // n if np.shape(v) else None
            for r, dev in enumerate(self.group.devices):
                part = v if rows is None else v[r * rows:(r + 1) * rows]
                shards[r].update(executor._coerce_feed(
                    self.program, {k: part}, device=dev))
        return shards

    def run(self, executor, feed, fetch_list, scope, return_numpy=True):
        import time

        from paddle_tpu_torch.observability import profiling

        scope = scope if scope is not None else ex.global_scope()
        fetch_names = [f.name if isinstance(f, Variable) else f
                       for f in (fetch_list or [])]
        shards = self._split_feed(executor, feed or {})
        # the step is captured when the executor captures and every
        # replica sits on one CUDA card; a graph is its scope's
        capture = executor.capture and len(set(self.group.devices)) == 1
        key = (self.program._version,
               tuple((k, tuple(v.shape), str(v.dtype))
                     for k, v in sorted(shards[0].items())),
               tuple(fetch_names), tuple(self.group.devices),
               id(scope) if capture else None)
        entry = self._entries.get(key)
        new = entry is None
        if new:
            t0 = time.perf_counter()
            plan = self._plans[key] = ex._Plan(
                self.program, shards[0].keys(), fetch_names)
            entry = self._entries[key] = ex._Signature(
                self.program, plan, self.group.devices, self.label,
                self.group)
            self._pins[key] = scope
            ex._m_compile_seconds().labels(path="dp", phase="trace").inc(
                time.perf_counter() - t0)
        first_run = not entry.ran
        t0 = time.perf_counter()
        with profiling.step_phases("dp", self.label) as ph:
            fetches = executor._run_signature(
                entry, self, scope, shards, fetch_names, ph, "dp", new,
                capture=capture and not entry.plan.eager_only)
            with ph.phase("fetch_sync"):
                # concatenate on dim 0 on the first replica's device; a
                # scalar becomes one element a replica
                dev0 = self.group.devices[0]
                fetches = [torch.cat([(f.reshape(1) if f.dim() == 0
                                       else f).to(dev0) for f in per])
                           for per in fetches]
                if return_numpy:
                    fetches = [f.detach().cpu().numpy() for f in fetches]
        step_s = time.perf_counter() - t0
        ex._record_step("dp", step_s, first_run)
        ex._report_examples("dp", ex._feed_batch(feed or {}), step_s)
        entry.ran = True
        executor._step += 1
        self._report()
        return fetches

    def replica_values(self, name):
        """Every replica's current tensor of persistable ``name``."""
        return list(self._replicas[name])

    def _report(self):
        """The per-step collective telemetry of the JAX runner."""
        per_step = getattr(self.program, "_collective_bytes_per_step", None)
        if per_step:
            fam = collective_payload_counter()
            for coll, nbytes in per_step.items():
                if nbytes:
                    fam.labels(collective=coll).inc(nbytes)
        sched = getattr(self.program, "_overlap_schedule", None)
        if sched and sched["enabled"] and sched["buckets"]:
            overlap_buckets_counter().inc(len(sched["buckets"]))
        saved = getattr(self.program, "_fused_update_bytes_saved", 0)
        if saved:
            fused_update_bytes_counter().inc(saved)
