"""Guards of the PyTorch port's boundaries.

* No file of ``src/repro_torch``, ``chip_smoke.py`` or the port's examples
  (``examples/*_torch.py``) imports ``jax``, the JAX
  package ``repro`` or ``ml_dtypes`` (JAX's dtype package, which the card's
  machine lacks; checked on the AST, and by importing the port in a fresh
  interpreter).
* The port's entry points default to the GPU and never fall back: asking
  for ``cuda`` without one raises; every unported serving option raises
  ``NotImplementedError``; the ported ones construct and run.
* The port's architecture numbers are the JAX package's.
"""

import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.config import get_arch as jax_get_arch
from repro.config import reduced as jax_reduced
from repro_torch.config import ArchConfig, get_arch, reduced, resolve_device
from repro_torch.models import build_model
from repro_torch.serving import Request, ServingConfig, ServingSession

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "examples" / "wavefront_mt_training_torch.py",
    ROOT / "examples" / "serve_multiarch_torch.py",
    ROOT / "examples" / "quickstart_torch.py",
]
FORBIDDEN = ("jax", "jaxlib", "repro", "ml_dtypes")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]


@pytest.mark.parametrize(
    "path", PORT_FILES, ids=[str(p.relative_to(ROOT)) for p in PORT_FILES]
)
def test_port_file_imports_no_jax_or_repro(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_imports_without_jax_in_a_fresh_interpreter():
    code = (
        "import sys\n"
        "import repro_torch.launch.serve, repro_torch.bridge\n"
        "import repro_torch.kernels.ops, repro_torch.launch.train\n"
        "import repro_torch.launch.profile, repro_torch.session\n"
        "import repro_torch.runtime, repro_torch.optim, repro_torch.data\n"
        "import repro_torch.models.encdec, repro_torch.ckpt\n"
        "import repro_torch.launch.faults\n"
        "bad = sorted(m for m in sys.modules "
        "if m.split('.')[0] in ('jax', 'jaxlib', 'repro', 'ml_dtypes'))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_serving_defaults_to_cuda_and_never_falls_back(monkeypatch):
    assert ServingConfig().device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        ServingSession(ServingConfig())
    with pytest.raises(RuntimeError, match="cuda"):
        build_model(reduced(get_arch("qwen3-0.6b")))
    assert resolve_device("cpu").type == "cpu"


@pytest.mark.parametrize("kw", [
    {"replan": "mix"},
    {"replan": "initial"},
    {"kv_layout": "slab"},
    {"prefill_chunk": 16},
    {"prefix_sharing": True},
    {"kv_admission": "grow"},
])
def test_unported_serving_options_raise(kw):
    if set(kw) & {"prefill_chunk", "prefix_sharing", "kv_admission"}:
        # ported: the session constructs and serves, and the option is on
        sess = ServingSession(ServingConfig(device="cpu", cache_len=48,
                                            page_size=8, replan="off", **kw))
        b = sess.batcher
        assert (b.prefill_chunk, b.index is not None, b.kv_admission) == (
            kw.get("prefill_chunk", 0), kw.get("prefix_sharing", False),
            kw.get("kv_admission", "reserve"))
        prefix = np.arange(20)
        sess.run([Request(rid=rid, tokens=np.concatenate([prefix, [rid]]),
                          max_new_tokens=12) for rid in range(3)])
        assert sorted(sess.results) == [0, 1, 2]
        m = sess.metrics()
        key = {"prefill_chunk": "chunk_steps", "prefix_sharing": "prefix_hits",
               "kv_admission": "kv_grow_allocs"}[next(iter(kw))]
        assert m[key] > 0, (key, m)
        return
    if "kv_layout" in kw:  # ported: the slab session constructs and serves
        sess = ServingSession(ServingConfig(device="cpu", cache_len=48,
                                            replan="off", **kw))
        b = sess.batcher
        assert (b.kv_layout, b.pool, b.kv_page_bytes) == ("slab", None, 0)
        sess.run([Request(rid=rid, tokens=np.arange(5 + rid),
                          max_new_tokens=6) for rid in range(3)])
        assert sorted(sess.results) == [0, 1, 2]
        assert sess.metrics()["kv_layout"] == "slab"
        return
    if "replan" in kw:  # ported: the session constructs and plans
        sess = ServingSession(ServingConfig(device="cpu", cache_len=32, **kw))
        assert sess.planner_session is not None
        for rid, n in enumerate((8, 20)):
            sess.submit(Request(rid=rid, tokens=np.arange(n), max_new_tokens=3,
                                family=f"f{rid}"))
            sess.step()
        assert sess.current_plan is not None and sess.current_plan.steps
        assert [r.mode for r in sess.replans] == (
            ["full", "full"] if kw["replan"] == "mix" else ["full"])
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ServingConfig(device="cpu", **kw)


@pytest.mark.parametrize("family", ["moe", "ssm", "hybrid", "vlm", "audio"])
def test_unported_families_raise(family):
    if family == "moe":  # ported: every registered MoE config builds
        for arch in ("qwen2-moe-a2.7b", "qwen3-moe-30b-a3b"):
            model = build_model(reduced(get_arch(arch)), device="cpu")
            assert model.cfg.family == "moe" and "router" in \
                model.impl.decoder.layers[0].ffn
        return
    if family == "hybrid":  # ported: recurrentgemma builds with rglru blocks
        model = build_model(reduced(get_arch("recurrentgemma-9b")),
                            device="cpu")
        layers = model.impl.decoder.layers
        assert model.cfg.family == "hybrid" and "rglru" in layers[0].mix
        assert "wq" in layers[2].mix
    elif family == "vlm":  # ported: pixtral's decoder takes stub embeds
        model = build_model(reduced(get_arch("pixtral-12b")), device="cpu")
        assert type(model.impl).__name__ == "Transformer"
    elif family == "audio":  # ported: seamless is the encoder-decoder
        model = build_model(reduced(get_arch("seamless-m4t-medium")),
                            device="cpu")
        assert type(model.impl).__name__ == "EncDecTransformer"
        assert not model.supports_chunked_prefill
    else:  # ported: xlstm-125m, the JAX package's one ssm arch, builds
        model = build_model(reduced(get_arch("xlstm-125m")), device="cpu")
        layers = model.impl.decoder.layers
        assert model.cfg.family == "ssm" and "w_if" in layers[0].mix
        assert "r" in layers[3].mix and not hasattr(layers[0], "ffn")
    # ported: an xLSTM cell beside attention builds; an unknown kind raises
    pattern = dataclasses.replace(reduced(get_arch("qwen3-0.6b")),
                                  block_pattern=("mlstm", "attn"))
    kinds = build_model(pattern, device="cpu").impl.decoder.kinds
    assert kinds == ("mlstm", "attn")
    unknown = dataclasses.replace(pattern, block_pattern=("mamba", "attn"))
    with pytest.raises(NotImplementedError, match="mixing kinds"):
        build_model(unknown, device="cpu")


@pytest.mark.parametrize("arch,shrink", [
    pytest.param(arch, shrink,
                 id=str(shrink) if arch == "qwen3-0.6b" else f"{arch}-{shrink}")
    for arch in ("qwen3-0.6b", "qwen2-moe-a2.7b", "qwen3-moe-30b-a3b",
                 "recurrentgemma-9b", "seamless-m4t-medium", "pixtral-12b",
                 "glm4-9b", "xlstm-125m")
    for shrink in (False, True)
])
def test_arch_config_matches_jax(arch, shrink):
    """Every arch the port registers."""
    port = get_arch(arch)
    ref = jax_get_arch(arch)
    if shrink:
        port, ref = reduced(port), jax_reduced(ref)
    fields = [f.name for f in dataclasses.fields(ArchConfig)]
    for name in fields:
        a, b = getattr(port, name), getattr(ref, name)
        if dataclasses.is_dataclass(a):
            a, b = dataclasses.asdict(a), dataclasses.asdict(b)
        assert a == b, f"{name}: port {a!r} != jax {b!r}"
