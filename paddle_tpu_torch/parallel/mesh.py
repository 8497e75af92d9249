"""Replica groups: the port's counterpart of
``paddle_tpu/parallel/mesh.py``.

The JAX package runs a data-parallel step as one program over a
``jax.sharding.Mesh``, driven by one controller (``shard_map``); its
tests put that mesh on 8 virtual CPU devices.  The port's counterpart
is one process driving N replicas in lockstep (fluid/executor.py
``run_plan``): a :class:`ReplicaGroup` is the ordered list of the
replicas' devices, taken from the ``places`` a user hands
``CompiledProgram.with_data_parallel``.  A place may repeat —
``[CUDAPlace(0)] * 4`` puts four replicas on one card, as the CPU mesh
puts eight devices on one host — because NCCL will not put two ranks on
one device.  The multi-process ``torch.distributed`` lane is ROADMAP
5.4.

The group has one axis, the data-parallel one, so every ``ring_id``
maps to the whole group, as the JAX package's ``axis_name_for_ring``
resolves any ring to the only axis of a one-axis mesh.  The ring map
that tells axes apart comes back with a lane that has more than one
(ZeRO-1, hybrid; ROADMAP slice 5).
"""

from __future__ import annotations

__all__ = ["ReplicaGroup"]


class ReplicaGroup:
    """The replicas of one data-parallel run: ``places`` in replica
    order and their torch devices."""

    def __init__(self, places):
        from paddle_tpu_torch.fluid import framework

        self.places = [framework.resolve_place(p) for p in places]
        self.devices = [p.torch_device() for p in self.places]

    @property
    def size(self):
        return len(self.devices)

    def __repr__(self):
        return f"ReplicaGroup({self.places})"
