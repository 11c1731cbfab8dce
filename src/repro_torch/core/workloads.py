"""The paper's MT MM evaluation workloads as TaskGraphs (Spindle §5.1, Tab. 1b).

Three workload families, matching the paper's configuration table:

  * **Multitask-CLIP** — ImageBind-style: per-modality encoder towers joined
    by a lightweight contrastive cross-modal module.  1.20B params, up to 6
    modalities / 10 tasks.  Cross-modal workload ≪ encoder workload.
  * **OFASys** — unified encoder-decoder LM as the cross-modal module, with
    lightweight per-modality adaptors.  0.66B params, 6 modalities / 7 tasks.
    Cross-modal ≈ encoders.
  * **QWen-VAL** — decoder-only LLM cross-modal module dominating the
    encoders.  9.25B params, 3 modalities / 3 tasks.

Plus ``mt_backbone_suite`` — a multi-task workload assembled from the
*assigned* architectures (qwen3-0.6b text tower, pixtral-ViT vision tower,
seamless speech encoder, shared decoder), exercising the planner on the
assigned families (DESIGN.md §6).

Workload numbers (flops/bytes per layer) are derived from standard
transformer accounting: train step ≈ 6·params·tokens FLOPs per layer.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from .graph import ComponentSpec, FlowSpec, GraphBuilder, OpWorkload, TaskGraph

BYTES_BF16 = 2


def transformer_layer_workload(
    d_model: int,
    d_ff: int,
    n_heads: int,
    batch: int,
    seq: int,
    *,
    training: bool = True,
) -> OpWorkload:
    """Per-layer workload for a standard transformer block."""
    tokens = batch * seq
    params = 4 * d_model * d_model + 3 * d_model * d_ff  # attn + swiglu
    attn_flops = 4 * tokens * seq * d_model  # QK^T + AV, fwd
    mm_flops = 2 * tokens * params
    fwd = mm_flops + attn_flops
    flops = 3 * fwd if training else fwd  # bwd ≈ 2× fwd
    act = tokens * d_model * BYTES_BF16
    bytes_hbm = (params * BYTES_BF16 + 8 * act) * (3 if training else 1)
    # Megatron TP: 2 all-reduces of the activation per layer (fwd), 2 (bwd).
    tp_comm = (4 if training else 2) * act
    return OpWorkload(
        flops=float(flops),
        bytes_hbm=float(bytes_hbm),
        param_bytes=float(params * BYTES_BF16),
        act_bytes=float(act),
        tp_comm_bytes=float(tp_comm),
    )


def loss_module_workload(d_model: int, batch: int) -> OpWorkload:
    """Lightweight contrastive-loss cross-modal module (Multitask-CLIP)."""
    flops = 6.0 * batch * batch * d_model  # similarity matrix fwd+bwd
    act = batch * d_model * BYTES_BF16
    return OpWorkload(
        flops=flops,
        bytes_hbm=4.0 * act,
        param_bytes=float(d_model * BYTES_BF16),
        act_bytes=float(act),
        tp_comm_bytes=0.0,
    )


@dataclass(frozen=True)
class TowerSpec:
    name: str
    n_layers: int
    d_model: int
    d_ff: int
    n_heads: int
    seq: int


# Representative modality encoder towers (ImageBind/OFASys-style sizes).
MODALITY_TOWERS: Dict[str, TowerSpec] = {
    "text": TowerSpec("text", 12, 768, 3072, 12, 77),
    "vision": TowerSpec("vision", 24, 1024, 4096, 16, 257),
    "audio": TowerSpec("audio", 12, 768, 3072, 12, 204),
    "video": TowerSpec("video", 24, 1024, 4096, 16, 784),
    "imu": TowerSpec("imu", 6, 512, 2048, 8, 391),
    "depth": TowerSpec("depth", 12, 768, 3072, 12, 257),
}

# Task roster: (task name, modality_a, modality_b). CLIP-style tasks pair a
# modality with text (ImageBind binds everything to vision/text).
MT_TASKS: List[Tuple[str, str, str]] = [
    ("img_text", "vision", "text"),
    ("audio_text", "audio", "text"),
    ("video_text", "video", "text"),
    ("depth_text", "depth", "text"),
    ("imu_text", "imu", "text"),
    ("audio_vision", "audio", "vision"),
    ("video_audio", "video", "audio"),
    ("depth_vision", "depth", "vision"),
    ("imu_video", "imu", "video"),
    ("text_text", "text", "text"),
]


def _tower_component(t: TowerSpec, suffix: str = "", *, shared: bool) -> ComponentSpec:
    def wl(batch: int, seq: int) -> OpWorkload:
        return transformer_layer_workload(
            t.d_model, t.d_ff, t.n_heads, batch, seq or t.seq
        )

    return ComponentSpec(
        name=f"{t.name}{suffix}",
        n_layers=t.n_layers,
        op_type=f"xf[{t.d_model}x{t.d_ff}]s{t.seq}",
        workload_fn=wl,
        shared=shared,
        merge_shared=False,
        max_tp=min(t.n_heads, 8),
    )


def multitask_clip(n_tasks: int = 4, batch_per_task: int = 64) -> TaskGraph:
    """Multitask-CLIP (ImageBind structure): towers + contrastive join."""
    assert 1 <= n_tasks <= len(MT_TASKS)
    towers = {name: _tower_component(t, shared=True) for name, t in MODALITY_TOWERS.items()}

    def loss_wl(batch: int, seq: int) -> OpWorkload:
        return loss_module_workload(768, batch)

    comps = list(towers.values()) + [
        ComponentSpec(
            name="contrastive",
            n_layers=1,
            op_type="contrastive",
            workload_fn=loss_wl,
            shared=False,
            max_tp=1,
        )
    ]
    gb = GraphBuilder(comps)
    for task, ma, mb in MT_TASKS[:n_tasks]:
        branches = [[ma]] if ma == mb else [[ma], [mb]]
        gb.add_flow(
            FlowSpec(
                task=task,
                branches=branches,
                join=["contrastive"],
                batch_size=batch_per_task,
                seq_lens={
                    ma: MODALITY_TOWERS[ma].seq,
                    mb: MODALITY_TOWERS[mb].seq,
                },
            )
        )
    return gb.build()


OFASYS_TASKS: List[Tuple[str, str]] = [
    ("caption", "vision"),
    ("asr", "audio"),
    ("vqa", "vision"),
    ("summ", "text"),
    ("video_cap", "video"),
    ("imu_cls", "imu"),
    ("depth_est", "depth"),
]


def ofasys(n_tasks: int = 4, batch_per_task: int = 32) -> TaskGraph:
    """OFASys: modality adaptors → shared enc-dec LM (cross-modal ≈ encoders)."""
    assert 1 <= n_tasks <= len(OFASYS_TASKS)
    # modality adaptors: full encoder towers (OFASys keeps per-modality
    # encoders; its unified enc-dec LM is sized so cross-modal ≈ encoders).
    adaptors = {}
    for name, t in MODALITY_TOWERS.items():
        adaptors[name] = _tower_component(t, suffix="_adaptor", shared=True)

    lm = TowerSpec("lm", 12, 1024, 4096, 16, 256)

    def lm_wl(batch: int, seq: int) -> OpWorkload:
        return transformer_layer_workload(
            lm.d_model, lm.d_ff, lm.n_heads, batch, seq or lm.seq
        )

    lm_comp = ComponentSpec(
        name="encdec_lm",
        n_layers=lm.n_layers,
        op_type=f"xf[{lm.d_model}x{lm.d_ff}]s{lm.seq}",
        workload_fn=lm_wl,
        shared=True,
        merge_shared=True,  # unified LM serves all tasks: execution barrier
        max_tp=8,
    )
    gb = GraphBuilder(list(adaptors.values()) + [lm_comp])
    for task, modality in OFASYS_TASKS[:n_tasks]:
        gb.add_flow(
            FlowSpec(
                task=task,
                branches=[[f"{modality}_adaptor"]],
                join=["encdec_lm"],
                batch_size=batch_per_task,
                seq_lens={
                    f"{modality}_adaptor": MODALITY_TOWERS[modality].seq,
                    "encdec_lm": lm.seq,
                },
            )
        )
    return gb.build()


QWEN_VAL_TASKS: List[Tuple[str, str]] = [
    ("vl_chat", "vision"),
    ("al_chat", "audio"),
    ("text_chat", "text"),
]


def qwen_val(n_tasks: int = 3, batch_per_task: int = 16) -> TaskGraph:
    """QWen-VAL: big decoder-only LLM dominates; small modality encoders."""
    assert 1 <= n_tasks <= len(QWEN_VAL_TASKS)
    enc_towers = {
        "vision": TowerSpec("vision", 40, 1664, 8192, 16, 257),   # ViT-bigG
        "audio": TowerSpec("audio", 32, 1280, 5120, 20, 750),     # Whisper-large
        "text": TowerSpec("text", 12, 768, 3072, 12, 512),
    }
    encoders = {
        name: _tower_component(t, suffix="_enc", shared=True)
        for name, t in enc_towers.items()
    }
    llm = TowerSpec("llm", 32, 4096, 11008, 32, 512)

    def llm_wl(batch: int, seq: int) -> OpWorkload:
        return transformer_layer_workload(
            llm.d_model, llm.d_ff, llm.n_heads, batch, seq or llm.seq
        )

    llm_comp = ComponentSpec(
        name="decoder_llm",
        n_layers=llm.n_layers,
        op_type=f"xf[{llm.d_model}x{llm.d_ff}]s{llm.seq}",
        workload_fn=llm_wl,
        shared=True,
        merge_shared=False,  # per-task batches; params sync via group pool
        max_tp=8,
    )
    gb = GraphBuilder(list(encoders.values()) + [llm_comp])
    for task, modality in QWEN_VAL_TASKS[:n_tasks]:
        gb.add_flow(
            FlowSpec(
                task=task,
                branches=[[f"{modality}_enc"]],
                join=["decoder_llm"],
                batch_size=batch_per_task,
                seq_lens={
                    f"{modality}_enc": enc_towers[modality].seq,
                    "decoder_llm": llm.seq,
                },
            )
        )
    return gb.build()


def mt_backbone_suite(batch_per_task: int = 8) -> TaskGraph:
    """Multi-task workload built from the ASSIGNED architectures:
    qwen3-0.6b text tower + pixtral-ViT vision tower + seamless speech
    encoder, joined by a shared glm4-9b-like decoder (DESIGN.md §6)."""
    qwen3 = TowerSpec("qwen3_text", 28, 1024, 3072, 16, 1024)
    pixvit = TowerSpec("pixtral_vit", 24, 1024, 4096, 16, 1024)
    seamless = TowerSpec("seamless_speech", 12, 1024, 4096, 16, 1024)
    glm4 = TowerSpec("glm4_dec", 40, 4096, 13696, 32, 1024)

    comps = [
        _tower_component(qwen3, shared=True),
        _tower_component(pixvit, shared=True),
        _tower_component(seamless, shared=True),
    ]

    def dec_wl(batch: int, seq: int) -> OpWorkload:
        return transformer_layer_workload(
            glm4.d_model, glm4.d_ff, glm4.n_heads, batch, seq or glm4.seq
        )

    comps.append(
        ComponentSpec(
            name="shared_decoder",
            n_layers=glm4.n_layers,
            op_type=f"xf[{glm4.d_model}x{glm4.d_ff}]s{glm4.seq}",
            workload_fn=dec_wl,
            shared=True,
            merge_shared=True,
            max_tp=8,
        )
    )
    gb = GraphBuilder(comps)
    for task, tower in [
        ("text_gen", "qwen3_text"),
        ("vision_chat", "pixtral_vit"),
        ("speech_chat", "seamless_speech"),
    ]:
        gb.add_flow(
            FlowSpec(
                task=task,
                branches=[[tower]],
                join=["shared_decoder"],
                batch_size=batch_per_task,
                seq_lens={tower: 1024, "shared_decoder": glm4.seq},
            )
        )
    return gb.build()


# ---------------------------------------------------------------------------
# Serving mixes — the live request mix of a ServingSession as a TaskGraph
# ---------------------------------------------------------------------------

#: default tower used for families without an explicit spec (a ~1B-class LM)
DEFAULT_SERVING_TOWER = TowerSpec("lm", 12, 1024, 4096, 16, 128)


def serving_mix_workload(
    mix: Sequence[Tuple[str, int, int]],
    *,
    tower: Optional[TowerSpec] = None,
    towers: Optional[Dict[str, TowerSpec]] = None,
    prefill_chunk: int = 0,
    prefix_hit_rate: float = 0.0,
) -> TaskGraph:
    """The active request mix of a serving session as a planner TaskGraph.

    ``mix`` is a sequence of ``(family, prompt_bucket, count)`` triples —
    the bucketized mix a :class:`repro_torch.serving.mix.MixTracker` snapshots.
    Each triple becomes one task flow: a per-family **prefill** component
    processing ``count`` prompts of ``prompt_bucket`` tokens (inference
    workload, no backward), joined by ONE merged **decode** component over
    the union batch at seq 1 (all active slots decode together — the
    continuous-batching barrier, exactly ``merge_shared`` semantics).

    ``prefill_chunk`` models DIP-style chunked prefill: buckets longer than
    the chunk become per-bucket **chunked towers** — ``ceil(bucket/chunk)``
    times the layer count at seq ``chunk`` — so the planner sees many small
    interleavable prefill ops instead of one monolithic prompt-length op
    (the op_type carries the chunk width, so chunked and one-shot plans
    never alias in the PlanCache).

    ``prefix_hit_rate`` models prefix sharing: the observed fraction of
    prompt positions served by page mapping instead of prefill compute.
    It shrinks every bucket's prefill length to the expected *suffix*
    (quantized to quarters so metric jitter cannot thrash the PlanCache;
    the op_type carries the quantized rate so shared and unshared plans
    never alias).

    Families key heterogeneity: a NEW family adds a component and reshapes
    every MetaLevel (incremental reuse finds nothing to keep — a full
    replan), while a count/bucket drift inside known families only changes
    batch sizes, which the incremental path replans level-by-level.

    ``tower`` sizes every family (the served model); per-family overrides go
    in ``towers``.  The workload signature (and hence PlanCache identity)
    falls out of :func:`repro_torch.core.plancache.workload_signature` as usual.
    """
    mix = [(f, b, c) for f, b, c in mix if c > 0]
    if not mix:
        raise ValueError("serving mix is empty: nothing to plan")
    base = tower or DEFAULT_SERVING_TOWER
    fam_tower = dict(towers or {})
    # quantize the hit rate to quarters, capped below 1.0 (even a perfectly
    # hot prefix leaves >= 1 suffix position to prefill)
    hit_q = min(max(round(float(prefix_hit_rate) * 4) / 4, 0.0), 0.75)

    def _prefill_comp(fam: str, name: str, seq_chunks: int) -> ComponentSpec:
        t = fam_tower.get(fam, base)

        def prefill_wl(batch: int, seq: int, t=t) -> OpWorkload:
            return transformer_layer_workload(
                t.d_model, t.d_ff, t.n_heads, batch, seq or t.seq,
                training=False,
            )

        marker = f"c{prefill_chunk}" if seq_chunks > 1 else ""
        if hit_q > 0:
            marker += f"h{int(hit_q * 100)}"
        return ComponentSpec(
            name=name,
            n_layers=t.n_layers * seq_chunks,
            op_type=f"prefill[{t.d_model}x{t.d_ff}]{marker}",
            workload_fn=prefill_wl,
            shared=True,
            merge_shared=False,
            max_tp=min(t.n_heads, 8),
        )

    comps: List[ComponentSpec] = []
    prefill_of: Dict[Tuple[str, int], Tuple[str, int]] = {}
    for fam, bucket, _ in sorted(mix):
        # the prefill the data plane actually runs is the expected SUFFIX:
        # shared-prefix positions arrive by page mapping, not compute
        eff = max(1, int(round(bucket * (1.0 - hit_q))))
        n_chunks = (
            -(-eff // prefill_chunk)
            if prefill_chunk and eff > prefill_chunk
            else 1
        )
        if n_chunks > 1:
            # chunked tower: per-bucket component (chunk count depends on
            # the bucket), seq shrinks to the chunk width
            name = f"{fam}_prefill_p{bucket}"
            seq = min(eff, prefill_chunk)
        else:
            name = f"{fam}_prefill"
            seq = eff
        prefill_of[(fam, bucket)] = (name, seq)
        if all(c.name != name for c in comps):
            comps.append(_prefill_comp(fam, name, n_chunks))

    def decode_wl(batch: int, seq: int) -> OpWorkload:
        return transformer_layer_workload(
            base.d_model, base.d_ff, base.n_heads, batch, max(seq, 1),
            training=False,
        )

    comps.append(
        ComponentSpec(
            name="decode",
            n_layers=base.n_layers,
            op_type=f"decode[{base.d_model}x{base.d_ff}]",
            workload_fn=decode_wl,
            shared=True,
            merge_shared=True,  # union batch: all slots step together
            max_tp=min(base.n_heads, 8),
        )
    )

    gb = GraphBuilder(comps)
    for fam, bucket, count in sorted(mix):
        name, seq = prefill_of[(fam, bucket)]
        gb.add_flow(
            FlowSpec(
                task=f"{fam}:p{bucket}",
                branches=[[name]],
                join=["decode"],
                batch_size=count,
                seq_lens={name: seq, "decode": 1},
            )
        )
    return gb.build()


def serving_default_mix() -> TaskGraph:
    """A representative serving mix (plan-only demos)."""
    return serving_mix_workload(
        [("chat", 32, 8), ("chat", 128, 4), ("code", 256, 2)]
    )


# Live serving mixes stay parameterized per request mix (the
# ServingSession builds them through a graph_factory); the registry entry
# below is the *representative* fixed mix, so the planner evaluation suite
# (tests iterate every entry) and plan-only drivers exercise a serving
# workload alongside the paper's training suite.
WORKLOADS = {
    "multitask_clip": multitask_clip,
    "ofasys": ofasys,
    "qwen_val": qwen_val,
    "mt_backbone_suite": mt_backbone_suite,
    "serving_mix": serving_default_mix,
}
