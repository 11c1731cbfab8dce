"""Architecture configs of the port (importing this package registers them).

Only the architectures this slice serves are registered; the others join
with the model families that run them (ROADMAP queue 1).
"""

from . import qwen2_moe_a2_7b  # noqa: F401  — import side-effect: register_arch()
from . import qwen3_0_6b  # noqa: F401
from . import qwen3_moe_30b_a3b  # noqa: F401
from . import recurrentgemma_9b  # noqa: F401
