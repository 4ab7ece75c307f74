"""Architecture config system + registry + the assigned input-shape sets.

Every assigned architecture registers an `ArchConfig` via its module in this
package; `get_config(name)` / `list_archs()` are the public API, and
`--arch <id>` on the launchers resolves through here. `reduced()` yields the
small-family config used by the per-arch CPU smoke tests (full configs are
only ever lowered abstractly in the dry-run).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert: int  # per-expert FFN width
    num_shared_experts: int = 0
    shared_d_ff: int = 0  # total width of the always-on shared expert
    router_aux_coef: float = 0.01
    capacity_factor: float = 1.25
    dispatch: str = "sort"  # "sort" (GFTR pattern) | "einsum" (dense baseline)


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 64
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk: int = 128  # SSD chunk length


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    num_heads: int = 4
    slstm_every: int = 2  # one sLSTM block per this many blocks (rest mLSTM)
    proj_factor_mlstm: float = 2.0
    proj_factor_slstm: float = 4.0 / 3.0


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads
    norm: str = "rmsnorm"  # rmsnorm | layernorm | nonparam_ln
    act: str = "swiglu"  # swiglu | gelu
    rope_theta: float = 500_000.0
    sliding_window: Optional[int] = None
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    # hybrid (zamba2-style): shared attention block applied every N ssm blocks
    shared_attn_every: int = 0
    # vlm: one cross-attn layer per this many self-attn layers
    cross_attn_every: int = 0
    vision_tokens: int = 1601  # stub patch-embedding count (llama-3.2-vision)
    # enc-dec (whisper): encoder layer count; frontend is a stub that provides
    # precomputed frame embeddings of length `encoder_len`.
    encoder_layers: int = 0
    encoder_len: int = 1500
    pad_vocab_to: int = 128  # pad vocab so TP sharding divides
    remark: str = ""
    source: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def padded_vocab(self) -> int:
        m = self.pad_vocab_to
        return -(-self.vocab_size // m) * m

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic decode: SSM/linear-recurrent families or SWA."""
        return self.family in ("ssm", "hybrid") or self.sliding_window is not None

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Input-shape sets (assigned): seq_len x global_batch
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}

ARCH_IDS = [
    "xlstm-125m",
    "qwen2-moe-a2.7b",
    "mixtral-8x7b",
    "zamba2-2.7b",
    "olmo-1b",
    "granite-8b",
    "starcoder2-7b",
    "h2o-danube-3-4b",
    "llama-3.2-vision-11b",
    "whisper-large-v3",
]

_MODULES = {
    "xlstm-125m": "xlstm_125m",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "mixtral-8x7b": "mixtral_8x7b",
    "zamba2-2.7b": "zamba2_2_7b",
    "olmo-1b": "olmo_1b",
    "granite-8b": "granite_8b",
    "starcoder2-7b": "starcoder2_7b",
    "h2o-danube-3-4b": "h2o_danube3_4b",
    "llama-3.2-vision-11b": "llama32_vision_11b",
    "whisper-large-v3": "whisper_large_v3",
}


def get_config(name: str) -> ArchConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


def get_reduced_config(name: str) -> ArchConfig:
    """Small same-family config for CPU smoke tests."""
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.REDUCED


def list_archs() -> list[str]:
    return list(ARCH_IDS)


def cell_is_runnable(arch: ArchConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """Shape-cell applicability (skips documented in DESIGN.md)."""
    if shape.name == "long_500k" and not arch.supports_long_context:
        return False, "long_500k needs sub-quadratic attention (full-attention arch)"
    if shape.name == "long_500k" and arch.family == "audio":
        return False, "long_500k is semantically void for the 30s-audio enc-dec backbone"
    return True, ""
