"""Hand-written Hopper kernels and their launch layer.

``_build`` builds ``csrc/*.cu`` with nvcc and binds it with ctypes
(K0).  Kernels: K1-K3 flash attention forward and backward
(``primitives.flash``), K4 fused bias+GeLU (``fused_bias_act``), K5 and
K7 paged attention over an fp32 and a dual-int8 pool
(``primitives.paged``), K6 ragged attention (``primitives.ragged``) and
K8 the fused dequant -> optimizer update -> requant step of the
data-parallel lane (``fused_update``, over the wire format of
``quantized_collectives`` and ``ring_collectives``).
Every wrapper launches its kernel for CUDA tensors, runs its plain
PyTorch version for CPU tensors, and counts its launches in
``<wrapper>.launches``.
"""


def kernel_wrappers():
    """{kernel name: wrapper} for every ported kernel — the functions
    whose ``launches`` counters a run can read and reset."""
    from .fused_bias_act import fused_bias_gelu
    from .fused_update import fused_update_kernel
    from .primitives.flash import flash_bwd_dkv, flash_bwd_dq, flash_fwd
    from .primitives.paged import paged_attention, paged_attention_quant
    from .primitives.ragged import ragged_attention

    return {"flash_fwd": flash_fwd, "flash_bwd_dq": flash_bwd_dq,
            "flash_bwd_dkv": flash_bwd_dkv,
            "fused_bias_act": fused_bias_gelu,
            "paged_attention": paged_attention,
            "ragged_attention": ragged_attention,
            "paged_attention_quant": paged_attention_quant,
            "fused_update": fused_update_kernel}
