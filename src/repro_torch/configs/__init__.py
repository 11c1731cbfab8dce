"""Architecture configs of the port (importing this package registers them).

Only the architectures this slice serves are registered; the others join
with the model families that run them (ROADMAP queue 1).
"""

from . import qwen3_0_6b  # noqa: F401  — import side-effect: register_arch()
