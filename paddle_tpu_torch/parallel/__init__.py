"""Parallel lanes (counterpart of ``paddle_tpu/parallel``).  Ported so
far: the data-parallel transpiler and its single-process replica runner
(``data_parallel``) over a replica group (``mesh``)."""

from .data_parallel import (DataParallelRunner,  # noqa: F401
                            transpile_data_parallel)
