"""Model configuration (a copy of ``repro.models.config``; pure Python).

One frozen dataclass describes dense / MoE / SSM / hybrid / VLM / enc-dec
LMs; the registry (``repro.models.registry``) dispatches on ``family``.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

__all__ = ["ModelConfig", "coded_blocks"]


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str               # dense | moe | ssm | hybrid | vlm | encdec
    n_layers: int
    d_model: int
    n_heads: int              # 0 for attention-free (ssm)
    n_kv_heads: int
    d_ff: int
    vocab: int

    head_dim: int = 0         # 0 -> d_model // n_heads
    mlp: str = "swiglu"       # swiglu | relu2 | gelu
    rope_theta: float = 5e5
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # --- MoE ---------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    moe_every: int = 1        # every k-th layer is MoE (1 = all layers)
    capacity_factor: float = 1.25
    shared_expert: bool = False  # llama4: dense "shared expert" beside routed

    # --- SSM (Mamba-2 SSD) --------------------------------------------
    ssm_state: int = 0        # N
    ssm_expand: int = 2       # d_inner = expand * d_model
    ssm_head_dim: int = 64    # P; n_ssm_heads = d_inner // P
    ssm_groups: int = 1       # G (B/C groups)
    ssm_chunk: int = 256      # SSD chunk length
    conv_width: int = 4

    # --- hybrid (zamba2): shared attention block cadence ---------------
    attn_every: int = 0       # shared attn+MLP block after every k SSM layers

    # --- VLM (llama-3.2-vision): gated cross-attn cadence --------------
    cross_attn_every: int = 0  # every k-th layer gets image cross-attention
    img_tokens: int = 1024     # stub frontend: precomputed patch embeddings

    # --- enc-dec (seamless): encoder depth; n_layers = decoder depth ----
    enc_layers: int = 0
    frame_tokens: int = 0      # stub speech frontend: precomputed frames/step

    # --- numerics / execution -----------------------------------------
    param_dtype: str = "float32"
    dtype: str = "bfloat16"   # activation/compute dtype
    remat: bool = True        # per-layer activation checkpointing in scan
    logit_chunk: int = 1024   # CE loss sequence chunking

    # --- coded-computation integration (the paper's technique) ---------
    coded: bool = False       # CodedLinear on decode-path projections
    coded_parity: int = 2     # parity blocks per coded projection

    # --- perf knobs (§Perf hillclimb; defaults = baseline) ---------------
    onehot_ce: bool = False   # CE label-pick as one-hot dot (vs take_along_axis
    #   which all-gathers vocab-sharded logits)
    pad_heads: int = 0        # pad attn heads to divide TP; pad outputs are
    #   masked so the function (and grads) equal the unpadded model exactly
    moe_dispatch_groups: int = 1  # shard-local MoE capacity/cumsum groups
    #   (breaks the cross-shard sequential cumsum chain)
    aligned_decode: bool = False  # batch-aligned decode positions: O(1)-token
    #   cache write (vs masked full-cache rewrite for ragged positions)

    def __post_init__(self):
        if self.family not in ("dense", "moe", "ssm", "hybrid", "vlm", "encdec"):
            raise ValueError(f"unknown family {self.family!r}")
        if self.family == "moe" and (self.n_experts < 2 or self.top_k < 1):
            raise ValueError("moe family needs n_experts >= 2 and top_k >= 1")
        if self.family in ("ssm", "hybrid") and self.ssm_state <= 0:
            raise ValueError("ssm/hybrid family needs ssm_state > 0")
        if self.family == "encdec" and self.enc_layers <= 0:
            raise ValueError("encdec family needs enc_layers > 0")
        if self.pad_heads and self.n_kv_heads:
            if (self.n_heads + self.pad_heads) % self.n_kv_heads != 0:
                raise ValueError(
                    "padded head count must stay a multiple of n_kv_heads "
                    f"(got {self.n_heads}+{self.pad_heads} vs kv={self.n_kv_heads})"
                )

    # ---- derived sizes ----------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def subquadratic(self) -> bool:
        """Can this arch run 500k-token decode? (SSM/hybrid O(1)-state or
        O(S)-per-step paths only; pure full-attention archs are skipped.)"""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decode(self) -> bool:
        return True  # all assigned archs are decoder-bearing (no encoder-only)

    def scaled(self, **overrides) -> "ModelConfig":
        """A reduced copy for smoke tests (same family/topology, tiny sizes)."""
        return replace(self, **overrides)

    # ---- parameter count (analytic; used for roofline MODEL_FLOPS) ----
    def param_count(self) -> tuple[int, int]:
        """(total_params, active_params) — active differs for MoE."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        hd = self.resolved_head_dim
        attn = d * self.n_heads * hd * 2 + d * self.n_kv_heads * hd * 2
        mlp_dense = d * f * (3 if self.mlp == "swiglu" else 2)
        embed = v * d * (1 if self.tie_embeddings else 2)

        def ssm_layer() -> int:
            din, g, n, h = self.d_inner, self.ssm_groups, self.ssm_state, self.n_ssm_heads
            in_p = d * (2 * din + 2 * g * n + h)
            conv = (din + 2 * g * n) * self.conv_width
            out_p = din * d
            return in_p + conv + out_p + din + 2 * h  # +gate-norm, dt_bias, A_log

        total = active = embed
        if self.family in ("dense",):
            total += self.n_layers * (attn + mlp_dense)
            active = total
        elif self.family == "moe":
            n_moe = self.n_layers // self.moe_every
            n_dense = self.n_layers - n_moe
            moe_l = self.n_experts * mlp_dense + d * self.n_experts
            if self.shared_expert:
                moe_l += mlp_dense
            total += self.n_layers * attn + n_dense * mlp_dense + n_moe * moe_l
            act_moe = self.top_k * mlp_dense + d * self.n_experts
            if self.shared_expert:
                act_moe += mlp_dense
            active = embed + self.n_layers * attn + n_dense * mlp_dense + n_moe * act_moe
        elif self.family == "ssm":
            total += self.n_layers * ssm_layer()
            active = total
        elif self.family == "hybrid":
            total += self.n_layers * ssm_layer() + (attn + mlp_dense)  # shared block
            active = total
        elif self.family == "vlm":
            n_cross = self.n_layers // max(self.cross_attn_every, 1) if self.cross_attn_every else 0
            cross = d * self.n_heads * hd * 2 + d * self.n_kv_heads * hd * 2
            total += self.n_layers * (attn + mlp_dense) + n_cross * cross
            active = total
        elif self.family == "encdec":
            total += self.enc_layers * (attn + mlp_dense)
            total += self.n_layers * (2 * attn + mlp_dense)  # self + cross
            active = total
        return int(total), int(active)


def coded_blocks(cfg: ModelConfig) -> int:
    """Total coded blocks for the serving head = TP width (one per shard).

    Lives here (jax-free) so launchers can resolve the coded-head geometry
    — e.g. for ``--dry-run`` config printing — without importing the model
    stack.
    """
    del cfg
    return 16
