"""Hand-written Hopper kernels and their launch layer.

``_build`` builds ``csrc/*.cu`` with nvcc and binds it with ctypes
(K0).  Kernels: K1-K3 flash attention forward and backward
(``primitives.flash``), K4 fused bias+GeLU (``fused_bias_act``), K5 and
K7 paged attention over an fp32 and a dual-int8 pool
(``primitives.paged``), K6 ragged attention (``primitives.ragged``) and
K8 the fused dequant -> optimizer update -> requant step of the
data-parallel lane (``fused_update``, over the wire format of
``quantized_collectives`` and ``ring_collectives``; the step runs its
group form, one launch over many parameters).
Every wrapper launches its kernel for CUDA tensors, runs its plain
PyTorch version for CPU tensors, and counts its launches in
``<wrapper>.launches``: the calls that launched the kernel, or recorded
it into a CUDA graph being captured.  A graph replay runs no Python, so
each kernel also counts itself on the card (``csrc/launch_count.cuh``):
:func:`device_launch_counts` reads the launches the device ran, eager
ones and replays alike.
"""


def kernel_wrappers():
    """{kernel name: wrapper} for every ported kernel — the functions
    whose ``launches`` counters a run can read and reset.  K8's is its
    group form, the one the data-parallel step launches
    (``fused_update.fused_update_kernel`` counts the per-parameter
    form's launches)."""
    from .fused_bias_act import fused_bias_gelu
    from .fused_update import fused_update_group
    from .primitives.flash import flash_bwd_dkv, flash_bwd_dq, flash_fwd
    from .primitives.paged import paged_attention, paged_attention_quant
    from .primitives.ragged import ragged_attention

    return {"flash_fwd": flash_fwd, "flash_bwd_dq": flash_bwd_dq,
            "flash_bwd_dkv": flash_bwd_dkv,
            "fused_bias_act": fused_bias_gelu,
            "paged_attention": paged_attention,
            "ragged_attention": ragged_attention,
            "paged_attention_quant": paged_attention_quant,
            "fused_update": fused_update_group}


def _counted():
    from .fused_update import fused_update_kernel

    return {**kernel_wrappers(), "fused_update_kernel": fused_update_kernel}


def launch_counts():
    """{wrapper name: launches so far} of every counting wrapper (K8's
    per-parameter form as ``fused_update_kernel``)."""
    return {k: w.launches for k, w in _counted().items()}


# (library, device counter slot) of each counting wrapper's kernel
_DEVICE_SLOTS = {
    "flash_fwd": ("flash_attention", 0),
    "flash_bwd_dq": ("flash_attention", 1),
    "flash_bwd_dkv": ("flash_attention", 2),
    "fused_bias_act": ("fused_bias_act", 0),
    "paged_attention": ("paged_attention", 0),
    "paged_attention_quant": ("paged_attention", 1),
    "ragged_attention": ("ragged_attention", 0),
    "fused_update": ("fused_update", 0),
    "fused_update_kernel": ("fused_update", 1),
}


def device_launch_counts():
    """{wrapper name: launches of its kernel the current device ran so
    far}, read from the kernels' own counters (0 for a library not
    loaded).  Synchronizes the device; not while a graph is captured."""
    from . import _build

    read = {}
    out = {}
    for k, (lib, slot) in _DEVICE_SLOTS.items():
        if lib not in read:
            read[lib] = _build.device_launches(lib, 3)
        out[k] = read[lib][slot] if read[lib] is not None else 0
    return out
