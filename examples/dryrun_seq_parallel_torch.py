"""Dry-run cells with Megatron-SP on, beside the same cells without it.

The dry-run CLI has no flag for ``seq_parallel`` (JAX's has none either);
this script passes it through ``run_cell(shcfg=...)``.  Each cell is
traced shape-only as rank 0 of a ``fake`` group of the mesh's size, with
the kernels on, and its per-rank memory and collective bytes are printed
as one JSON line.  Runs on any host (no GPU)::

    PYTHONPATH=src python examples/dryrun_seq_parallel_torch.py
    PYTHONPATH=src python examples/dryrun_seq_parallel_torch.py \\
        --arch qwen3-0.6b --shape train_4k
"""

import argparse
import json

from repro_torch.config import default_sharding, get_arch
from repro_torch.launch.dryrun import run_cell


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-405b")
    ap.add_argument("--shape", default="train_4k")
    args = ap.parse_args(argv)
    cfg = get_arch(args.arch)
    for multi_pod in (False, True):
        for sp in (False, True):
            rec = run_cell(cfg, args.shape, multi_pod=multi_pod,
                           verbose=False,
                           shcfg=default_sharding(cfg, use_kernels=True,
                                                  seq_parallel=sp))
            if not rec["ok"]:
                raise SystemExit(f"{rec['mesh']} sp={sp}: {rec['error']}")
            mem = rec["memory"]
            print(json.dumps({
                "arch": rec["arch"], "shape": rec["shape"],
                "mesh": rec["mesh"], "seq_parallel": sp,
                "argument_gb": mem["argument_size_in_bytes"] / 1e9,
                "temp_gb": mem["temp_size_in_bytes"] / 1e9,
                "argument_plus_temp_gb": (mem["argument_size_in_bytes"]
                                          + mem["temp_size_in_bytes"]) / 1e9,
                "collectives_gb": {k: v / 1e9 for k, v in
                                   rec["collectives"].items() if v},
                "launches": {k: v for k, v in rec["launches"].items() if v},
                "trace_s": rec["compile_s"]}), flush=True)


if __name__ == "__main__":
    main()
