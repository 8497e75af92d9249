"""The finite checks (counterpart of ``paddle_tpu/health/detect.py``).

``all_finite`` and ``found_inf`` are the on-device reductions the
sentinel's in-step check and the AMP ops compute: one scalar tensor,
never read on the host, so a captured step holds them.  ``host_scan``
is FLAGS_check_nan_inf's scan: it reads each value on the host and
raises naming the first variable that holds a NaN or an Inf.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["all_finite", "found_inf", "host_scan"]


def _float_tensors(xs):
    return [x for x in xs
            if isinstance(x, torch.Tensor) and x.is_floating_point()]


def all_finite(xs, device=None):
    """One bool scalar tensor: True when every float tensor of ``xs``
    is finite throughout.  Other values (integer tensors, None, anything
    not a tensor) are ignored; with none left it is True, made on
    ``device``.  Two kernels a tensor (``isfinite``, ``all``) and one
    to join them: no host read."""
    ts = _float_tensors(xs)
    if not ts:
        return torch.ones((), dtype=torch.bool, device=device)
    oks = [torch.isfinite(t).all() for t in ts]
    return oks[0] if len(oks) == 1 else torch.stack(oks).all()


def found_inf(xs, device=None):
    """``all_finite`` inverted, as the float32 [1] the program's
    ``@HEALTH@found_inf`` carries."""
    return (~all_finite(xs, device)).float().reshape(1)


def _host_array(val):
    if isinstance(val, torch.Tensor):
        return val.detach().float().cpu().numpy() \
            if val.is_floating_point() else None
    try:
        a = np.asarray(val)
    except (TypeError, ValueError):
        return None
    return a if np.issubdtype(a.dtype, np.floating) else None


def host_scan(named_values, label):
    """FLAGS_check_nan_inf: read each (name, value) on the host and raise
    RuntimeError naming the first float variable holding a NaN or an Inf
    after ``label`` ran; integer and non-array values are skipped."""
    for name, val in named_values:
        a = _host_array(val)
        if a is not None and not np.isfinite(a).all():
            raise RuntimeError(
                f"FLAGS_check_nan_inf: variable {name!r} contains "
                f"NaN/Inf after {label}")
