"""Architecture configs of the port (importing this package registers them).

All ten of the JAX package's architectures.  The dense deepseek-67b and
llama3-405b fit no single card: they train, prefill and serve from a
state placed by the sharding rules (``launch/steps.py``: FSDP over
``"data"``, tensor parallelism over ``"model"``) on a mesh large enough
to hold them; on the production (16, 16) mesh their local shapes are
held against JAX's specs on a ``"meta"`` build.
"""

from . import deepseek_67b  # noqa: F401  — import side-effect: register_arch()
from . import glm4_9b  # noqa: F401
from . import llama3_405b  # noqa: F401
from . import pixtral_12b  # noqa: F401
from . import qwen2_moe_a2_7b  # noqa: F401
from . import qwen3_0_6b  # noqa: F401
from . import qwen3_moe_30b_a3b  # noqa: F401
from . import recurrentgemma_9b  # noqa: F401
from . import seamless_m4t_medium  # noqa: F401
from . import xlstm_125m  # noqa: F401

#: the JAX package's assignment list, in its order (the dry run's cells)
ASSIGNED = [
    "qwen2-moe-a2.7b",
    "qwen3-moe-30b-a3b",
    "llama3-405b",
    "qwen3-0.6b",
    "deepseek-67b",
    "glm4-9b",
    "seamless-m4t-medium",
    "xlstm-125m",
    "pixtral-12b",
    "recurrentgemma-9b",
]
