"""Roofline model: compute / memory / collective terms per (arch x shape)
(twin of ``repro.launch.roofline``), with an NVIDIA H100's constants.

Two sources, cross-checked:
  1. the analytic model (this file, the reference's verbatim): closed-form
     FLOPs / HBM / collective bytes from the architecture, the sharding
     strategy and the shape -- the primary roofline numbers;
  2. the fake-rank dry-run (``launch/dryrun.py``): FLOPs and collective
     bytes of the ops one rank executes in the cell's step.  The
     reference's dry-run reads the compiled HLO, where XLA counts a loop
     body once, and multiplies by the cell's trip hints; the port's counts
     every executed op, so ``terms_from_cell`` does not multiply again (a
     divergence by design: ``hlo_flops`` keeps the reference's name and
     holds the executed count).

Hardware constants: one H100 SXM (NVIDIA's data sheet, dense, at the 700 W
limit) -- 989 TFLOP/s bf16 on the tensor cores, 3.35 TB/s HBM.  The link:
a 16-rank ``model`` axis spans two 8-GPU NVLink nodes, so the binding link
of its collectives is NDR InfiniBand, 400 Gb/s = 50 GB/s a GPU (NVLink's
450 GB/s a direction binds only within a node).
"""
from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.configs.base import SHAPES, ArchConfig

PEAK_FLOPS = 989e12        # bf16 dense / GPU (H100 SXM)
HBM_BW = 3.35e12           # bytes/s / GPU
LINK_BW = 50e9             # bytes/s / GPU: NDR InfiniBand, 400 Gb/s


@dataclasses.dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float         # global 6ND-style useful FLOPs
    hlo_flops: float           # per device: the dry-run's executed ops
    flops_ratio: float         # model / (hlo * chips)
    bottleneck: str
    details: dict


# ---------------------------------------------------------------------------
# analytic FLOPs (global, per step)
# ---------------------------------------------------------------------------

def _attn_flops_per_layer(cfg: ArchConfig, s: int, b: int,
                          causal: bool = True) -> float:
    """QK^T + AV matmul FLOPs, forward, one layer."""
    if cfg.vq_attn:
        ctx = 2 * cfg.vq_window + cfg.vq_k
        return 2.0 * 2 * b * cfg.n_heads * s * ctx * cfg.hd
    factor = 0.5 if causal else 1.0
    return 2.0 * 2 * b * cfg.n_heads * s * s * cfg.hd * factor


def active_params(cfg: ArchConfig) -> float:
    """Parameters touched per token (MoE: top-k experts only)."""
    if cfg.family != "moe":
        return float(cfg.param_count())
    d, ff = cfg.d_model, cfg.d_ff
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    attn = d * hq * hd + 2 * d * hkv * hd + hq * hd * d
    per_layer = attn + 2 * d + d * cfg.n_experts \
        + cfg.top_k * 3 * d * ff
    return float(cfg.n_layers * per_layer + cfg.vocab * cfg.d_model * 2)


def model_flops(cfg: ArchConfig, shape_name: str) -> float:
    sh = SHAPES[shape_name]
    b, s = sh["global_batch"], sh["seq_len"]
    n_act = active_params(cfg)
    if sh["kind"] == "train":
        tokens = b * s
        matmul = 6.0 * n_act * tokens
        attn = 3.0 * cfg.n_layers * _attn_flops_per_layer(cfg, s, b)
        if cfg.family == "hybrid":
            attn = 3.0 * (cfg.n_layers // cfg.attn_period) * \
                _attn_flops_per_layer(cfg, s, b)
        if cfg.family in ("ssm",):
            attn = 3.0 * (cfg.n_layers // 2) * \
                _attn_flops_per_layer(cfg, s, b)    # mLSTM parallel form
        return matmul + attn
    if sh["kind"] == "prefill":
        tokens = b * s
        matmul = 2.0 * n_act * tokens
        attn = cfg.n_layers * _attn_flops_per_layer(cfg, s, b)
        return matmul + attn
    # decode: one token per sequence
    matmul = 2.0 * n_act * b
    if cfg.vq_attn:
        ctx = cfg.vq_k + cfg.vq_window
    else:
        ctx = s
    n_attn_layers = cfg.n_layers
    if cfg.family == "hybrid":
        n_attn_layers = cfg.n_layers // cfg.attn_period
    if cfg.family == "ssm":
        # recurrent state update instead of attention
        return matmul + 2.0 * b * (cfg.n_layers // 2) * (
            3 * cfg.d_model * cfg.d_model)
    attn = 2.0 * 2 * b * cfg.n_heads * ctx * cfg.hd * n_attn_layers
    return matmul + attn


# ---------------------------------------------------------------------------
# analytic HBM traffic (per chip, per step)
# ---------------------------------------------------------------------------

def model_hbm_bytes(cfg: ArchConfig, shape_name: str, chips: int,
                    accum: int, strategy: str) -> float:
    sh = SHAPES[shape_name]
    b, s = sh["global_batch"], sh["seq_len"]
    p_bytes = cfg.param_count() * 2            # bf16
    p_local = p_bytes / chips if strategy != "replicate" else p_bytes
    d = cfg.d_model

    if sh["kind"] == "train":
        # fwd+bwd weight reads per microbatch (remat: fwd again in bwd) +
        # grad write + optimizer read/write (bf16 moments x2)
        weight_traffic = p_local * (3 * accum + 1 + 4)
        act = 2 * (b * s / chips) * d * cfg.n_layers * 2 * 3
        return weight_traffic + act
    if sh["kind"] == "prefill":
        weight_traffic = p_local
        act = 2 * (b * s / chips) * d * cfg.n_layers * 2
        kv = 2 * (b * s / chips) * cfg.n_kv_heads * cfg.hd * 2 * cfg.n_layers
        return weight_traffic + act + kv
    # decode: weights once + KV cache read once per token
    apar = active_params(cfg) * 2 / chips if strategy != "replicate" \
        else active_params(cfg) * 2
    if cfg.vq_attn:
        kv_tokens = cfg.vq_k + cfg.vq_window
    elif cfg.family == "ssm":
        kv_tokens = 0
    else:
        kv_tokens = s
    n_kv_layers = cfg.n_layers
    if cfg.family == "hybrid":
        n_kv_layers = cfg.n_layers // cfg.attn_period
    kv = 2 * (b / max(1, chips // max(1, _seq_shards(cfg, shape_name, chips)))
              ) * kv_tokens * cfg.n_kv_heads * cfg.hd * 2 * n_kv_layers
    # per chip: the cache is sharded over the mesh; total read = global/chips
    kv = 2 * b * kv_tokens * cfg.n_kv_heads * cfg.hd * 2 * n_kv_layers / chips
    state = 0.0
    if cfg.family in ("ssm", "hybrid"):
        state = 2 * b * cfg.n_layers * (2 * d) * max(cfg.ssm_state, 64) * 4 \
            / chips
    return apar + kv + state


def _seq_shards(cfg, shape_name, chips):
    return 1


# ---------------------------------------------------------------------------
# analytic collective traffic (per chip, per step)
# ---------------------------------------------------------------------------

def model_collective_bytes(cfg: ArchConfig, shape_name: str, chips: int,
                           tp: int, dp: int, accum: int,
                           strategy: str) -> float:
    """Ring-model bytes crossing each GPU's binding link per step."""
    sh = SHAPES[shape_name]
    b, s = sh["global_batch"], sh["seq_len"]
    d = cfg.d_model
    p_bytes = cfg.param_count() * 2

    if sh["kind"] == "train":
        # data-parallel gradient all-reduce: 2 (n-1)/n x grad bytes/shard
        grad_ar = 2.0 * (dp - 1) / dp * p_bytes / tp
        tok_total = b * s / dp     # tokens passing each chip per STEP
        if strategy == "tp_fsdp":
            # FSDP param all-gather per microbatch (fwd + bwd re-gather)
            fsdp_ag = 2 * accum * (dp - 1) / dp * p_bytes / tp
            # Megatron TP: 2 all-reduces (attn out, mlp out) fwd + 2 bwd
            # per layer; the whole batch's tokens cross once per step
            # (accum only re-gathers params, it does not add token traffic)
            tp_ar = (cfg.n_layers * 4 *
                     2.0 * (tp - 1) / tp * tok_total * d * 2)
            return grad_ar + fsdp_ag + tp_ar
        if strategy == "moe_ep_dp":
            fsdp_ag = 2 * accum * (dp - 1) / dp * p_bytes / tp
            # one combine all-reduce per MoE layer over the token block
            ep_ar = (cfg.n_layers * 2.0 * (tp - 1) / tp * tok_total * d * 2)
            return grad_ar + fsdp_ag + ep_ar
        if strategy == "fsdp":
            fsdp_ag = 2 * accum * (chips - 1) / chips * p_bytes
            return grad_ar + fsdp_ag
        return 2.0 * (chips - 1) / chips * p_bytes   # replicated DP
    if sh["kind"] == "prefill":
        tok_local = b * s / dp
        if strategy == "tp_fsdp":
            return cfg.n_layers * 2 * 2.0 * (tp - 1) / tp * tok_local * d * 2 \
                + (dp - 1) / dp * p_bytes / tp
        if strategy == "moe_ep_dp":
            return cfg.n_layers * 2.0 * (tp - 1) / tp * tok_local * d * 2 \
                + (dp - 1) / dp * p_bytes / tp
        return (chips - 1) / chips * p_bytes
    # decode
    b_local = max(1.0, b / dp)
    if strategy == "tp_fsdp":
        # 2 all-reduces per layer on [b_local, 1, d]
        return cfg.n_layers * 2 * 2.0 * (tp - 1) / tp * b_local * d * 2
    if strategy == "moe_ep_dp":
        return cfg.n_layers * 2.0 * (tp - 1) / tp * b_local * d * 2
    if strategy == "fsdp":
        return (chips - 1) / chips * active_params(cfg) * 2
    return 0.0


# ---------------------------------------------------------------------------
# assemble terms
# ---------------------------------------------------------------------------

def terms_from_cell(cell: dict[str, Any], cfg: ArchConfig) -> RooflineTerms:
    chips = 512 if cell["mesh"] == "pod2x16x16" else 256
    tp = 16
    dp = chips // tp
    hints = cell.get("trip_hints", {})
    accum = hints.get("accum", 1)
    layer_trips = hints.get("layer_trips", cfg.n_layers)
    inner = hints.get("inner_attn_trips", 1)
    strategy = cell["strategy"]
    shape_name = cell["shape"]

    mf = model_flops(cfg, shape_name)
    compute_s = mf / (chips * PEAK_FLOPS)

    hbm = model_hbm_bytes(cfg, shape_name, chips, accum, strategy)
    memory_s = hbm / HBM_BW

    coll = model_collective_bytes(cfg, shape_name, chips, tp, dp, accum,
                                  strategy)
    collective_s = coll / LINK_BW

    # the dry-run's flops per device: every executed op counted, so no
    # trip correction (the reference multiplies by layer_trips * accum)
    hlo_flops = cell["cost"]["flops"]
    # the dry-run's collectives, ring factors; executed ops, no trips
    cb = cell["collectives"]["bytes"]
    ring = {"all-gather": (tp - 1) / tp, "reduce-scatter": (tp - 1) / tp,
            "all-reduce": 2 * (tp - 1) / tp, "all-to-all": 1.0 / tp,
            "collective-permute": 1.0}
    hlo_coll = sum(ring[k] * cb.get(k, 0) for k in ring)

    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    return RooflineTerms(
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        model_flops=mf, hlo_flops=hlo_flops,
        flops_ratio=mf / max(hlo_flops * chips, 1.0),
        bottleneck=bottleneck,
        details={"hbm_bytes": hbm, "coll_bytes": coll,
                 "hlo_coll_bytes": hlo_coll, "chips": chips,
                 "accum": accum, "layer_trips": layer_trips,
                 "inner_attn_trips": inner,
                 "step_time_bound_s": max(terms.values()),
                 "roofline_fraction": compute_s / max(terms.values())})
