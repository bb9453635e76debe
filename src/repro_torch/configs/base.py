"""Configuration dataclasses for the PyTorch port.

The port's own copy of ``repro/configs/base.py`` (the slice's part of it):
every architecture is one frozen ``ModelConfig`` and quantization settings
are one ``QuantConfig``, field for field as in the reference, so a config
built for one package means the same thing in the other.
"""
from __future__ import annotations

from dataclasses import dataclass


# ---------------------------------------------------------------------------
# Model configuration
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyper-parameters.

    ``family`` selects the assembly code path:
      dense   -- decoder-only transformer (GQA + RoPE + SwiGLU)
      moe     -- decoder-only transformer with mixture-of-experts FFN
      ssm     -- attention-free Mamba-2 (SSD) stack
      hybrid  -- Jamba-style interleave of Mamba + attention + MoE
      encdec  -- encoder-decoder transformer (speech/text, frontend stubbed)
      vlm     -- decoder-only transformer with interleaved cross-attention
                 layers attending to precomputed image patch embeddings
    """

    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // n_heads

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0        # DeepSeek-V3 style shared expert(s)
    first_k_dense: int = 0           # first k layers use dense FFN
    d_ff_dense: int = 0              # dense FFN width when first_k_dense > 0
    capacity_factor: float = 1.25
    router_aux_loss: float = 0.001

    # --- SSM (Mamba-2 / SSD) ---
    ssm_state: int = 0               # N: state dimension
    d_inner: int = 0                 # expanded inner width (0 -> 2*d_model)
    ssm_head_dim: int = 64           # P: SSD head dim
    ssm_chunk: int = 256             # SSD chunk length
    conv_kernel: int = 4

    # --- hybrid (Jamba) ---
    attn_every: int = 0              # one attention layer per this many layers
    moe_every: int = 0               # MoE FFN on layers where (idx % moe_every)==moe_offset
    moe_offset: int = 1

    # --- attention ---
    rope_theta: float = 10000.0
    sliding_window: int = 0          # >0 -> sliding-window attention (Mixtral)
    attn_logit_softcap: float = 0.0
    qkv_bias: bool = False

    # --- encoder-decoder ---
    n_enc_layers: int = 0
    n_dec_layers: int = 0
    enc_frames_cap: int = 4096       # max encoder memory length used in decode shapes

    # --- VLM ---
    cross_attn_every: int = 0        # one cross-attn layer per this many layers
    n_image_tokens: int = 1601       # patch embeddings per image (stub frontend)

    # --- misc ---
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    act: str = "swiglu"              # swiglu | gelu
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    norm_eps: float = 1e-5

    # --- provenance ---
    source: str = ""                 # citation from the assignment table
    subquadratic: bool = False       # can run long_500k decode
    notes: str = ""

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def resolved_d_inner(self) -> int:
        return self.d_inner if self.d_inner else 2 * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.resolved_d_inner // self.ssm_head_dim

    def param_count(self) -> int:
        """Analytic total parameter count (embedding included)."""
        D, F, V = self.d_model, self.d_ff, self.vocab_size
        H, Kv, hd = self.n_heads, self.n_kv_heads, self.resolved_head_dim
        embed = V * D
        head = 0 if self.tie_embeddings else D * V
        attn = D * H * hd + 2 * D * Kv * hd + H * hd * D

        def dense_ffn(width: int) -> int:
            return 3 * D * width  # SwiGLU: gate + up + down

        total = embed + head
        if self.family in ("dense", "vlm"):
            per_layer = attn + dense_ffn(F) + 2 * D
            total += self.n_layers * per_layer
            if self.family == "vlm" and self.cross_attn_every:
                n_cross = self.n_layers // self.cross_attn_every
                total += n_cross * (attn + 2 * D)  # cross-attn projections+norms
        elif self.family == "moe":
            moe_ffn = self.n_experts * 3 * D * F + D * self.n_experts
            shared = self.n_shared_experts * 3 * D * F
            n_moe = self.n_layers - self.first_k_dense
            total += n_moe * (attn + moe_ffn + shared + 2 * D)
            total += self.first_k_dense * (attn + dense_ffn(self.d_ff_dense or F) + 2 * D)
        elif self.family == "ssm":
            di, N = self.resolved_d_inner, self.ssm_state
            nh = self.n_ssm_heads
            # in_proj -> [z, x, B, C, dt], conv over (x,B,C), out_proj
            per_layer = (D * (2 * di + 2 * N + nh) + self.conv_kernel * (di + 2 * N)
                         + 2 * nh + di + di * D + 2 * D)
            total += self.n_layers * per_layer
        elif self.family == "hybrid":
            di, N = self.resolved_d_inner, self.ssm_state
            nh = self.n_ssm_heads
            mamba_l = (D * (2 * di + 2 * N + nh) + self.conv_kernel * (di + 2 * N)
                       + 2 * nh + di + di * D + 2 * D)
            moe_ffn = self.n_experts * 3 * D * F + D * self.n_experts
            for idx in range(self.n_layers):
                is_attn = self.attn_every and (idx % self.attn_every == self.attn_every // 2)
                total += attn + 2 * D if is_attn else mamba_l
                is_moe = self.moe_every and (idx % self.moe_every == self.moe_offset)
                total += moe_ffn if is_moe else dense_ffn(F)
                total += D  # ffn norm
        elif self.family == "encdec":
            enc = self.n_enc_layers * (attn + dense_ffn(F) + 2 * D)
            dec = self.n_dec_layers * (2 * attn + dense_ffn(F) + 3 * D)
            total += enc + dec
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE top-k counting)."""
        if self.family not in ("moe", "hybrid") or not self.n_experts:
            return self.param_count()
        D, F = self.d_model, self.d_ff
        per_expert = 3 * D * F
        inactive = (self.n_experts - self.top_k) * per_expert
        if self.family == "moe":
            n_moe = self.n_layers - self.first_k_dense
        else:
            n_moe = sum(1 for idx in range(self.n_layers)
                        if self.moe_every and idx % self.moe_every == self.moe_offset)
        return self.param_count() - n_moe * inactive


# ---------------------------------------------------------------------------
# Quantization configuration (the paper's technique)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class QuantConfig:
    """Quantization settings (paper Sec. 2.2-2.4 plus baselines).

    ``method`` selects the algorithm from the ``repro_torch.quantize``
    registry: "daq" (paper Alg. 1, objective = ``metric``) or "absmax".
    """

    method: str = "daq"              # registry key (repro_torch.quantize)
    fmt: str = "fp8_e4m3"            # fp8_e4m3 | fp8_e5m2 | int8 | int4
    granularity: str = "block"       # tensor | channel | block
    block_size: int = 128
    metric: str = "sign"             # sign | cosine | mse | hybrid
    alpha_min: float = 0.8
    alpha_max: float = 1.25
    n_coarse: int = 5
    n_fine: int = 10
    fine_delta: float = 0.0          # 0 -> one coarse grid step
    per_block_alpha: bool = False    # beyond-paper: independent alpha per block/channel
    use_fused_kernel: bool = False   # one-pass candidate sweep kernel (block fp8)
    hybrid_lambda: float = 0.5       # hybrid = lambda*sign + (1-lambda)*cosine
    skip_patterns: tuple[str, ...] = ("norm", "bias", "router", "a_log", "ssm_dt", "conv")

    def resolved_fine_delta(self) -> float:
        if self.fine_delta:
            return self.fine_delta
        return (self.alpha_max - self.alpha_min) / max(self.n_coarse - 1, 1)
