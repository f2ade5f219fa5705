"""Roofline of a dry-run cell on the H100 — the port of the JAX package's
``repro/roofline/analysis.py``.

Three terms per (arch × shape × mesh), all in seconds:

    compute    = FLOPs_per_device / PEAK_FLOPS
    memory     = bytes_per_device / HBM_BW
    collective = Σ_ops ring_time(op_kind, bytes, group) over the
                 collectives the step issues

The FLOPs, bytes and collectives are what :mod:`.counter` counts while
the step runs eagerly, on each device's local shards.

Hardware model: H100 SXM5 80 GB at 700 W (NVIDIA's data sheet, dense
figures) — bf16 989 TFLOP/s on the tensor cores, f32 67 TFLOP/s off
them, HBM3 3.35 TB/s; NVLink 4 at 450 GB/s a direction between the 8
cards of a node, NDR InfiniBand at 50 GB/s a card between nodes. Ranks
lie :data:`GPUS_PER_NODE` to a node in mesh order, so a group of 16
consecutive ranks crosses two nodes. A collective is priced at the
slowest link its group crosses, by the ring cost model (n = group size):

    all-gather      bytes_out × (n-1)/n / BW
    reduce-scatter  bytes_in  × (n-1)/n / BW
    all-reduce      2 × bytes × (n-1)/n / BW
    all-to-all      bytes × (n-1)/n / BW
    collective-permute  bytes / BW
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable

PEAK_FLOPS = 989e12        # bf16 FLOP/s a card, dense, tensor cores
F32_FLOPS = 67e12          # f32 FLOP/s a card off the tensor cores
HBM_BW = 3.35e12           # bytes/s a card
NVLINK_BW = 450e9          # bytes/s a card a direction, inside a node
IB_BW = 50e9               # bytes/s a card, between nodes
GPUS_PER_NODE = 8
CARD_BYTES = 80e9          # device memory a card

__all__ = ["PEAK_FLOPS", "F32_FLOPS", "HBM_BW", "NVLINK_BW", "IB_BW",
           "GPUS_PER_NODE", "CARD_BYTES", "CollectiveStats", "Roofline",
           "analyze", "link_bw", "model_flops_for", "ring_seconds"]


def link_bw(ranks: Iterable[int]) -> float:
    """The slowest link a group of ``ranks`` crosses: NVLink inside one
    node, InfiniBand across nodes."""
    nodes = {r // GPUS_PER_NODE for r in ranks}
    return NVLINK_BW if len(nodes) <= 1 else IB_BW


def ring_seconds(kind: str, nbytes: float, ranks) -> float:
    """Ring time of one collective of ``kind`` moving ``nbytes`` (the
    result of an all-gather, the operand of the others) over ``ranks``."""
    ranks = list(ranks)
    n = len(ranks)
    if n <= 1:
        return 0.0
    bw = link_bw(ranks)
    frac = (n - 1) / n
    if kind == "all-reduce":
        return 2 * nbytes * frac / bw
    if kind == "collective-permute":
        return nbytes / bw
    return nbytes * frac / bw


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_kind: Dict[str, int]
    seconds_by_kind: Dict[str, float]
    count: int

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())

    @property
    def total_seconds(self) -> float:
        return sum(self.seconds_by_kind.values())


# ----------------------------------------------------------------------------
@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    collective: CollectiveStats
    model_flops: float            # 6·N_active·D (global)
    memory_per_device: Dict[str, float]
    step_kind: str
    bytes_by_opcode: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def compute_s(self) -> float:
        return self.flops_per_device / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.bytes_per_device / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.collective.total_seconds

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        total = self.flops_per_device * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """useful-compute time / achievable step time (max of the terms):
        how close the step is to the compute roofline for its useful FLOPs."""
        useful_s = (self.model_flops / self.chips) / PEAK_FLOPS
        bound = max(self.compute_s, self.memory_s, self.collective_s)
        return useful_s / bound if bound else 0.0

    def to_dict(self) -> Dict[str, Any]:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips, "step_kind": self.step_kind,
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "collective_bytes": self.collective.bytes_by_kind,
            "collective_count": self.collective.count,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bottleneck": self.bottleneck,
            "model_flops": self.model_flops,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            "memory_per_device": self.memory_per_device,
            "bytes_by_opcode": self.bytes_by_opcode,
        }


def analyze(stats, *, arch: str, shape: str, mesh_name: str, chips: int,
            model_flops: float, step_kind: str,
            memory: Dict[str, float] = None) -> Roofline:
    """The three terms from a :class:`~.counter.CountStats` of one step.

    ``memory`` carries the step's own sizes (``argument_size_in_bytes``,
    ``temp_size_in_bytes``); the counter adds the attention-score bytes
    and the memory term without them (what a flash kernel, which keeps
    the scores on chip, would leave)."""
    coll = CollectiveStats(
        {k: int(v) for k, v in stats.collective_bytes.items()},
        dict(stats.collective_seconds), stats.collective_count)
    mem = {k: float(v) for k, v in (memory or {}).items()}
    mem["bytes_scores_class"] = float(stats.bytes_scores_class)
    mem["memory_s_flash_equiv"] = float(
        (stats.bytes_accessed - stats.bytes_scores_class) / HBM_BW)
    return Roofline(arch=arch, shape=shape, mesh=mesh_name, chips=chips,
                    flops_per_device=float(stats.flops),
                    bytes_per_device=float(stats.bytes_accessed),
                    collective=coll, model_flops=model_flops,
                    memory_per_device=mem, step_kind=step_kind,
                    bytes_by_opcode=dict(stats.bytes_by_opcode))


def model_flops_for(cfg, shape_name: str, seq: int, global_batch: int,
                    step_kind: str) -> float:
    """Useful model FLOPs: 6·N_active·D plus the attention term
    (PaLM-appendix-style MFU accounting — at 32k+ context the S² attention
    FLOPs dominate the parameter FLOPs and must be credited)."""
    n_active = cfg.active_param_count()
    h, hd = cfg.n_heads, cfg.resolved_head_dim

    def attn_fwd_per_seq(s_ctx: int) -> float:
        """QKᵀ + PV over a causal context (½ the pairs count)."""
        if cfg.is_attention_free or not h:
            return 0.0
        l_attn = cfg.n_layers
        eff = s_ctx
        if cfg.family == "hybrid":
            pat = cfg.hybrid.pattern or ("attn",)
            l_attn = cfg.n_layers * sum(1 for p in pat if p == "attn") / len(pat)
            eff = min(s_ctx, 2 * cfg.hybrid.window)  # local window
        per_layer = 2.0 * s_ctx * eff * h * hd  # causal ½ × (2 matmuls × 2)
        enc = 0.0
        if cfg.family == "encdec":
            t = cfg.encdec.n_frames
            enc = cfg.encdec.n_enc_layers * 4.0 * t * t * h * hd  # bidirectional
        return l_attn * per_layer + enc

    if step_kind == "train":
        return (6.0 * n_active * seq +
                3.0 * attn_fwd_per_seq(seq)) * global_batch
    if step_kind == "prefill":
        return (2.0 * n_active * seq + attn_fwd_per_seq(seq)) * global_batch
    # decode: one token against an s_ctx-deep cache → 4·S·H·Dh per layer
    l_attn = cfg.n_layers
    eff = seq
    if cfg.family == "hybrid":
        pat = cfg.hybrid.pattern or ("attn",)
        l_attn = cfg.n_layers * sum(1 for p in pat if p == "attn") / len(pat)
        eff = min(seq, cfg.hybrid.window)
    attn_dec = 0.0 if (cfg.is_attention_free or not h) else \
        l_attn * 4.0 * eff * h * hd
    return (2.0 * n_active + attn_dec) * global_batch
