"""Serve four architecture families through the port's one API: attention
KV caches, recurrent O(1) state (Griffin's RG-LRU and xLSTM's cells) and
encoder-decoder cross-attention memory, all through the queue-driven
continuous-batching ServingSession — the port of
``examples/serve_multiarch.py``.

    PYTHONPATH=src python examples/serve_multiarch_torch.py           # GPU
    PYTHONPATH=src python examples/serve_multiarch_torch.py --device cpu
    PYTHONPATH=src python examples/serve_multiarch_torch.py --slab

Reduced configs, random weights from a seed; ``--slab`` serves every arch
on per-slot KV slabs instead of the page pool.  Exits non-zero when an
arch generates no tokens.
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.launch.serve import serve  # noqa: E402

ARCHS = ("qwen3-0.6b", "recurrentgemma-9b", "seamless-m4t-medium",
         "xlstm-125m")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (hand-written kernels) or cpu (plain PyTorch)")
    ap.add_argument("--slab", action="store_true",
                    help="per-slot KV slabs instead of the page pool")
    args = ap.parse_args()
    for arch in ARCHS:
        print(f"\n== {arch} ==")
        out = serve(arch, reduced_cfg=True, n_requests=4, prompt_len=24,
                    gen_len=12, device=args.device,
                    kv_layout="slab" if args.slab else "paged")
        if out["output_tokens"] <= 0:
            print(f"serve_multiarch_torch FAILED: {arch} generated nothing",
                  file=sys.stderr)
            return 1
    print("\nserve_multiarch_torch OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
