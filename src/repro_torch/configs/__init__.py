"""Architecture configs of the port (importing this package registers them).

Only the architectures the port serves are registered: the dense
deepseek-67b and llama3-405b, which no single card holds, join with
multi-GPU (ROADMAP queue 1, item 5c).
"""

from . import glm4_9b  # noqa: F401  — import side-effect: register_arch()
from . import pixtral_12b  # noqa: F401
from . import qwen2_moe_a2_7b  # noqa: F401
from . import qwen3_0_6b  # noqa: F401
from . import qwen3_moe_30b_a3b  # noqa: F401
from . import recurrentgemma_9b  # noqa: F401
from . import seamless_m4t_medium  # noqa: F401
from . import xlstm_125m  # noqa: F401
