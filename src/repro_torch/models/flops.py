"""Analytic FLOPs / HBM-bytes / collective-bytes model per (arch x shape),
the JAX package's formulas unchanged: pure arithmetic on the config.

For a train shape, `estimate(...).model_flops` is a step's 6 N_active D
and `flops_total` its matmul FLOPs with the recompute. MoE layers count
`tokens x top_k` routed rows, not the padded capacity the dispatch runs
(`moe._capacity`), so executed FLOPs exceed the estimate.

Conventions:
  * train FLOPs = fwd x (1 + 2 [bwd] + 1 [remat recompute inside scan]) for
    scanned blocks, fwd x 3 for unscanned (embed/head).
  * all matmuls are 2mnk; attention scores/AV are counted explicitly
    (the 6ND rule misses them at long context).
  * bytes/collectives are per *device* per step under the DESIGN.md §6
    sharding (FSDP over data, TP over model, DP over pod x data).
"""
from __future__ import annotations

import dataclasses

from ..configs.base import ArchConfig, ShapeSpec
from .model import num_params


@dataclasses.dataclass
class CostEstimate:
    flops_total: float  # whole step, all chips
    flops_layer_fwd: float  # one scanned-unit forward (for HLO cross-check)
    model_flops: float  # 6*N*D(active) reference
    hbm_bytes_per_device: float
    collective_bytes_per_device: float
    notes: dict


def _attn_flops(b, s, cfg: ArchConfig, kv_len=None):
    """qkvo projections + scores + AV for one layer, forward."""
    d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    kv_len = kv_len or s
    if cfg.sliding_window:
        kv_len = min(kv_len, cfg.sliding_window)
    proj = 2 * b * s * d * (H * hd + 2 * KV * hd + H * hd)
    scores = 2 * b * H * s * kv_len * hd * 2  # QK^T and AV
    return proj + scores


def _mlp_flops(b, s, d, f, kind):
    mats = 3 if kind == "swiglu" else 2
    return 2 * b * s * d * f * mats


def _moe_flops(b, s, cfg: ArchConfig):
    m = cfg.moe
    tok = b * s
    cap_tok = tok * m.top_k  # capacity-bounded routed tokens
    routed = 2 * cap_tok * cfg.d_model * m.d_expert * 3
    router = 2 * tok * cfg.d_model * m.num_experts
    shared = 2 * tok * cfg.d_model * m.shared_d_ff * 3 if m.num_shared_experts else 0
    return routed + router + shared


def _ssm_flops(b, s, cfg: ArchConfig):
    c = cfg.ssm
    d = cfg.d_model
    inner = c.expand * d
    nheads = inner // c.head_dim
    n = c.state_dim
    Q = min(c.chunk, s)
    proj = 2 * b * s * d * (2 * inner + 2 * n + nheads) + 2 * b * s * inner * d
    # intra-chunk quadratic + state path
    intra = 2 * b * s * Q * (n + nheads * c.head_dim)
    state = 2 * b * s * nheads * c.head_dim * n * 2
    return proj + intra + state


def _xlstm_pair_flops(b, s, cfg: ArchConfig):
    x = cfg.xlstm
    d = cfg.d_model
    inner = int(x.proj_factor_mlstm * d)
    nh = x.num_heads
    dk = inner // nh
    # mLSTM: up/down + qkv + quadratic
    m = 2 * b * s * d * (2 * inner) + 2 * b * s * inner * d
    m += 2 * b * s * inner * 3 * dk * nh // nh  # qkv projections (inner->inner)
    m += 2 * b * nh * s * s * dk * 2
    # sLSTM: gates W + R recurrent + out + mlp
    hd = d // nh
    sl = 2 * b * s * d * d * 4 + 2 * b * s * nh * hd * hd * 4
    sl += 2 * b * s * d * d + 2 * b * s * d * int(x.proj_factor_slstm * d) * 2
    return m + sl


def layer_fwd_flops(cfg: ArchConfig, b: int, s: int) -> float:
    """Forward FLOPs of one scanned unit."""
    fam = cfg.family
    if fam == "dense":
        return _attn_flops(b, s, cfg) + _mlp_flops(b, s, cfg.d_model, cfg.d_ff, cfg.act)
    if fam == "moe":
        return _attn_flops(b, s, cfg) + _moe_flops(b, s, cfg)
    if fam == "ssm":
        return _xlstm_pair_flops(b, s, cfg)
    if fam == "hybrid":
        grp = cfg.shared_attn_every * _ssm_flops(b, s, cfg)
        grp += _attn_flops(b, s, cfg) + _mlp_flops(b, s, cfg.d_model, cfg.d_ff, cfg.act)
        return grp
    if fam == "vlm":
        selfs = (cfg.cross_attn_every - 1) * (
            _attn_flops(b, s, cfg) + _mlp_flops(b, s, cfg.d_model, cfg.d_ff, cfg.act)
        )
        cross = _attn_flops(b, s, cfg, kv_len=cfg.vision_tokens) + _mlp_flops(
            b, s, cfg.d_model, cfg.d_ff, cfg.act
        )
        return selfs + cross
    if fam == "audio":
        dec = (
            _attn_flops(b, s, cfg)
            + _attn_flops(b, s, cfg, kv_len=cfg.encoder_len)
            + _mlp_flops(b, s, cfg.d_model, cfg.d_ff, cfg.act)
        )
        return dec
    raise ValueError(fam)


def _num_scan_units(cfg: ArchConfig) -> int:
    if cfg.family in ("dense", "moe"):
        return cfg.num_layers
    if cfg.family == "ssm":
        return cfg.num_layers // cfg.xlstm.slstm_every
    if cfg.family == "hybrid":
        return cfg.num_layers // cfg.shared_attn_every
    if cfg.family == "vlm":
        return cfg.num_layers // cfg.cross_attn_every
    if cfg.family == "audio":
        return cfg.num_layers
    raise ValueError(cfg.family)


def _active_params(cfg: ArchConfig) -> float:
    """Parameters touched per token (MoE: top-k + shared only)."""
    n = num_params(cfg)
    if cfg.moe is None:
        return n
    m = cfg.moe
    per_expert = 3 * cfg.d_model * m.d_expert
    n_inactive = (m.num_experts - m.top_k) * per_expert * cfg.num_layers
    return n - n_inactive


def estimate(cfg: ArchConfig, shape: ShapeSpec, mesh_shape: dict,
             *, param_bytes: int = 2, opt_bytes: int = 12,
             remat_factor: float = 4.0) -> CostEstimate:
    b, s = shape.global_batch, shape.seq_len
    chips = 1
    for v in mesh_shape.values():
        chips *= v
    dp = mesh_shape.get("data", 1) * mesh_shape.get("pod", 1)
    tp = mesh_shape.get("model", 1)
    N = num_params(cfg)
    Nact = _active_params(cfg)
    units = _num_scan_units(cfg)
    d = cfg.d_model

    if shape.kind == "train":
        lf = layer_fwd_flops(cfg, b, s)
        embed_head = 2 * b * s * d * cfg.padded_vocab * (1 if cfg.tie_embeddings else 1)
        if cfg.family == "audio":
            enc_f = cfg.encoder_layers * (
                _attn_flops(b, cfg.encoder_len, cfg)
                + _mlp_flops(b, cfg.encoder_len, d, cfg.d_ff, cfg.act)
            )
        else:
            enc_f = 0.0
        fwd = units * lf + embed_head + enc_f
        total = units * lf * remat_factor + (embed_head + enc_f) * 3
        model_flops = 6.0 * Nact * b * s
        # HBM per device: params, grads, optimizer state + remat activation traffic
        p_loc = N / chips
        hbm = p_loc * param_bytes * 2  # read params, write updated
        hbm += p_loc * 4 * 2  # grads f32 accumulate rw (approx)
        hbm += p_loc * opt_bytes * 2  # opt state rw
        act = b * s * d * 2 / dp  # one residual stream per layer boundary
        hbm += act * units * 4  # ckpt write + read + recompute rw
        hbm += b * s * cfg.padded_vocab * 2 / dp * 2  # logits rw
        # collectives per device:
        #   FSDP all-gather params (fwd+bwd+remat = 3x) + grad reduce-scatter
        #   + DP all-reduce across pod axis
        fsdp = mesh_shape.get("data", 1)
        coll = 0.0
        if fsdp > 1:
            coll += 3 * (N / tp) * param_bytes * (fsdp - 1) / fsdp / fsdp  # AG per dev
            coll += (N / tp) * 4 * (fsdp - 1) / fsdp / fsdp  # grad RS (f32)
        if mesh_shape.get("pod", 1) > 1:
            pods = mesh_shape["pod"]
            coll += 2 * (N / (tp * fsdp)) * 4 * (pods - 1) / pods  # cross-pod AR
        if tp > 1:
            # 2 activation all-reduces per unit fwd (+2 bwd, +2 remat)
            ar = b * s * d * 2 / dp * (tp - 1) / tp
            coll += 6 * units * ar
        notes = {"kind": "train"}
    else:
        # decode (and prefill handled as forward-only train-like below)
        if shape.kind == "prefill":
            lf = layer_fwd_flops(cfg, b, s)
            embed_head = 2 * b * s * d * cfg.padded_vocab
            total = units * lf + embed_head
            model_flops = 2.0 * Nact * b * s
            p_loc = N / chips
            hbm = p_loc * param_bytes + b * s * d * 2 / dp * units
            coll = 0.0
            if mesh_shape.get("data", 1) > 1:
                coll += (N / tp) * param_bytes / mesh_shape.get("data", 1)
            if tp > 1:
                coll += 2 * units * b * s * d * 2 / dp * (tp - 1) / tp
            notes = {"kind": "prefill"}
            return CostEstimate(total, lf, model_flops, hbm, coll, notes)
        # decode: one token per sequence against cache of length s
        kv_len = min(s, cfg.sliding_window) if cfg.sliding_window else s
        total = 2.0 * Nact * b  # param matmuls
        cache_bytes = 0.0
        if cfg.family in ("dense", "moe", "vlm", "audio", "hybrid"):
            # attention cache read per layer
            attn_layers = {
                "dense": cfg.num_layers,
                "moe": cfg.num_layers,
                "vlm": cfg.num_layers,
                "audio": cfg.num_layers,
                "hybrid": cfg.num_layers // max(cfg.shared_attn_every, 1),
            }[cfg.family]
            total += 2.0 * b * attn_layers * cfg.num_kv_heads * cfg.hd * kv_len * 2
            cache_bytes += attn_layers * b * kv_len * cfg.num_kv_heads * cfg.hd * 2 * 2
        if cfg.family == "hybrid":
            inner = cfg.ssm.expand * d
            nheads = inner // cfg.ssm.head_dim
            cache_bytes += cfg.num_layers * b * nheads * cfg.ssm.head_dim * cfg.ssm.state_dim * 4
        if cfg.family == "ssm":
            x = cfg.xlstm
            inner = int(x.proj_factor_mlstm * d)
            dk = inner // x.num_heads
            cache_bytes += (cfg.num_layers // x.slstm_every) * b * x.num_heads * dk * dk * 4
        model_flops = 2.0 * Nact * b
        p_loc = N / chips
        hbm = p_loc * param_bytes + cache_bytes / chips
        coll = 0.0
        if tp > 1:
            coll += 2 * _num_scan_units(cfg) * b * d * 2 * (tp - 1) / tp
        lf = 0.0
        notes = {"kind": "decode", "kv_len": kv_len}
    return CostEstimate(total, lf, model_flops, hbm, coll, notes)
