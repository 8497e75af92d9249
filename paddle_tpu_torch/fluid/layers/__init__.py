"""Layer functions (counterpart of ``paddle_tpu/fluid/layers``)."""

from .io import data  # noqa: F401
from .control_flow import *  # noqa: F401,F403
from .control_flow import __all__ as _control_flow_all
from . import detection  # noqa: F401
from .detection import *  # noqa: F401,F403
from .detection import __all__ as _detection_all
from .learning_rate_scheduler import *  # noqa: F401,F403
from .learning_rate_scheduler import __all__ as _lr_all
from .metric_op import *  # noqa: F401,F403
from .metric_op import __all__ as _metric_all
from .nn import *  # noqa: F401,F403
from .nn import __all__ as _nn_all
from .nn_tail2 import *  # noqa: F401,F403
from .nn_tail2 import __all__ as _nn_tail2_all
from .rnn import *  # noqa: F401,F403
from .rnn import __all__ as _rnn_all
from .structured import *  # noqa: F401,F403
from .structured import __all__ as _structured_all
from .tensor import *  # noqa: F401,F403
from .tensor import __all__ as _tensor_all

__all__ = (["data"] + list(_control_flow_all) + list(_detection_all)
           + list(_lr_all)
           + list(_metric_all) + list(_nn_all) + list(_nn_tail2_all) + list(_rnn_all)
           + list(_structured_all) + list(_tensor_all))
