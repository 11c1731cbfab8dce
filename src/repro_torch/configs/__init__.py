"""Architecture configs of the port (importing this package registers them).

Only the architectures the port serves are registered: xlstm-125m joins
with the xLSTM cells (ROADMAP queue 1, item 4b), and the dense
deepseek-67b and llama3-405b, which no single card holds, with multi-GPU
(item 5).
"""

from . import glm4_9b  # noqa: F401  — import side-effect: register_arch()
from . import pixtral_12b  # noqa: F401
from . import qwen2_moe_a2_7b  # noqa: F401
from . import qwen3_0_6b  # noqa: F401
from . import qwen3_moe_30b_a3b  # noqa: F401
from . import recurrentgemma_9b  # noqa: F401
from . import seamless_m4t_medium  # noqa: F401
