"""Collective ops over a replica group (counterpart of
``paddle_tpu/ops/collective_ops.py``).

Each is registered ``collective=True``: the executor calls it once for
the whole replica group (fluid/executor.py ``run_plan``) with, for each
input slot, the list of every replica's value, and it returns, for each
output slot, the list of every replica's result.  ``ctx.group`` is the
ReplicaGroup (parallel/mesh.py), or None outside one: there the JAX
package's single-device meaning holds — the identity, and
``local_keep_quant`` for ``c_allreduce_quant_keep`` — as on a one-GPU
NCCL ring.

Sums run in replica order, one replica's value after another, on the
first replica's device, and every replica gets its own copy of the
result.  Ported so far: the ops the data-parallel lane emits
(``c_allreduce_sum``, ``c_allreduce_avg``, ``c_allreduce_quant``,
``c_allreduce_quant_keep``, ``uncoalesce_tensor``), the stream-sync
identities and the no-op bootstrap ops.  No grad ops: no collective sits
inside this lane's backward.
"""

from __future__ import annotations

from paddle_tpu_torch.fluid.registry import register_op, simple_op
from paddle_tpu_torch.kernels import quantized_collectives as qc
from paddle_tpu_torch.kernels import ring_collectives as rc


def _group(ctx, attrs):
    """The group this op's ring reduces over, or None (identity).  The
    group has one axis, so every ``ring_id`` reduces over all of it
    (parallel/mesh.py)."""
    group = getattr(ctx, "group", None)
    if group is None or group.size < 2:
        return None
    return group


def _replicated(value, xs):
    """``value`` on every replica's device, each its own tensor."""
    return [value.to(x.device, copy=True) for x in xs]


def _c_allreduce(mean):
    def lower(ctx, xs, attrs):
        if _group(ctx, attrs) is None:
            return list(xs)
        dev = xs[0].device
        acc = xs[0]
        for x in xs[1:]:
            acc = acc + x.to(dev)
        if mean:
            acc = acc / len(xs)
        return _replicated(acc, xs)

    return lower


register_op("c_allreduce_sum", ["X"], ["Out"], _c_allreduce(False),
            grad=None, collective=True)
register_op("allreduce", ["X"], ["Out"], _c_allreduce(False), grad=None,
            collective=True)
register_op("c_allreduce_avg", ["X"], ["Out"], _c_allreduce(True),
            grad=None, collective=True)


def _block_size(attrs):
    return int(attrs.get("block_size", qc.DEFAULT_BLOCK_SIZE))


def _dual(attrs):
    return int(attrs.get("quant_bits", 16)) != 8


@simple_op("c_allreduce_quant", ["X"], ["Out"], grad=None, collective=True)
def _c_allreduce_quant(ctx, xs, attrs):
    """Block-scaled int8 all-reduce-sum: the algorithm the transpiler
    stamped in ``algo`` (kernels/ring_collectives.py); exact identity
    outside a group."""
    if _group(ctx, attrs) is None:
        return list(xs)
    return rc.adaptive_quantized_all_reduce(
        xs, block_size=_block_size(attrs), dual_int8=_dual(attrs),
        algo=attrs.get("algo", "auto"),
        crossover_kb=attrs.get("crossover_kb"))


@simple_op("c_allreduce_quant_keep", ["X"], ["QHi", "QLo", "QScale"],
           grad=None, collective=True)
def _c_allreduce_quant_keep(ctx, xs, attrs):
    """``c_allreduce_quant`` that keeps the reduced bucket in its wire
    format: each replica gets the assembled (hi, lo, scales), which the
    fused optimizer ops read in place (K8).  Outside a group the value
    is quantized locally once."""
    bs, dual = _block_size(attrs), _dual(attrs)
    if _group(ctx, attrs) is None:
        outs = [rc.local_keep_quant(x, bs, dual) for x in xs]
    else:
        outs = rc.adaptive_quantized_all_reduce_keep(
            xs, block_size=bs, dual_int8=dual,
            algo=attrs.get("algo", "auto"),
            crossover_kb=attrs.get("crossover_kb"))
    return tuple(list(col) for col in zip(*outs))


@simple_op("uncoalesce_tensor", ["X"], ["Out*"], grad=None)
def _uncoalesce_tensor(ctx, x, attrs):
    """Split a coalesced bucket back into its members
    (``attrs["shapes"]``).  Replica-local: not a collective."""
    parts, off = [], 0
    for s in attrs.get("shapes", []):
        shape = tuple(int(d) for d in s)
        size = 1
        for d in shape:
            size *= d
        parts.append(x[off:off + size].reshape(shape))
        off += size
    return parts


def _identity(ctx, xs, attrs):
    return list(xs)


# stream-sync ops: the executor's in-order stream subsumes them, as
# XLA's dataflow does in the JAX package
for _name in ("c_sync_calc_stream", "c_identity", "c_wait_compute",
              "c_wait_comm"):
    register_op(_name, ["X"], ["Out"], _identity, grad=None, collective=True)
register_op("c_sync_comm_stream", ["X*"], ["Out*"], _identity, grad=None,
            collective=True)


def _noop(ctx, attrs):
    return None


# communicator bootstrap ops: the replica group is the communicator
for _name in ("c_comm_init", "c_comm_init_all", "c_gen_nccl_id",
              "gen_nccl_id"):
    register_op(_name, [], [], _noop, grad=None)
