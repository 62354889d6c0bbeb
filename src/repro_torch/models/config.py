"""Unified model configuration (a copy of ``repro.models.config``).

A single frozen dataclass covers every family; family-specific fields are
zero/None when unused.  The port keeps its own copy so that it imports
nothing of the JAX package; the two must stay field-for-field equal so a
config means the same model in both.
"""

from __future__ import annotations

from dataclasses import dataclass, replace


def round_up(x: int, multiple: int) -> int:
    return ((x + multiple - 1) // multiple) * multiple


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0
    top_k: int = 0
    d_ff: int = 0                  # per-expert hidden
    n_shared_experts: int = 0      # llama4-style always-on shared expert(s)
    shared_d_ff: int = 0
    capacity_factor: float = 1.25
    aux_loss_coef: float = 0.01
    # expert-parallel degree is derived at mesh-build time: ep = gcd(E, tp)


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention dims (MiniCPM3 / DeepSeek-V2 style)."""

    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    qk_nope_head_dim: int = 64
    qk_rope_head_dim: int = 32
    v_head_dim: int = 64


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) block dims."""

    d_state: int = 64
    head_dim: int = 64
    expand: int = 2
    conv_kernel: int = 4
    chunk: int = 128
    # derived: d_inner = expand * d_model; n_heads = d_inner // head_dim


@dataclass(frozen=True)
class XLSTMConfig:
    slstm_every: int = 4           # every 4th block is sLSTM, rest mLSTM
    mlstm_proj_factor: float = 2.0
    slstm_proj_factor: float = 4.0 / 3.0
    conv_kernel: int = 4
    chunk: int = 64


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # decoder | zamba | xlstm | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 => d_model // n_heads
    # --- attention variants ---
    attn_type: str = "gqa"         # gqa | mla
    qkv_bias: bool = False
    attn_softcap: float = 0.0      # gemma2: 50.0
    final_softcap: float = 0.0     # gemma2: 30.0
    sliding_window: int = 0        # 0 => full attention
    local_global_period: int = 0   # gemma2: 2 (alternate local/global)
    rope_theta: float = 10000.0
    rope_pct: float = 1.0          # stablelm-2: partial rotary (0.25)
    mrope: bool = False            # qwen2-vl 3D rotary
    mrope_sections: tuple = (16, 24, 24)   # t/h/w split of head_dim/2
    mla: MLAConfig | None = None
    # --- mixture of experts ---
    moe: MoEConfig | None = None
    # --- ssm / hybrid ---
    ssm: SSMConfig | None = None
    attn_every: int = 0            # zamba: shared attn block period
    # --- xlstm ---
    xlstm: XLSTMConfig | None = None
    # --- encoder-decoder ---
    n_enc_layers: int = 0
    n_dec_layers: int = 0
    # --- modality frontend stubs ---
    vision_tokens: int = 0         # qwen2-vl patch embeds per sample
    audio_frontend: bool = False   # seamless frame embeddings
    enc_memory_len: int = 4096     # enc memory length for decode shapes
    # --- numerics ---
    dtype: str = "bfloat16"
    norm_eps: float = 1e-6
    vocab_round: int = 256
    tie_embeddings: bool = False
    emb_scale: bool = False        # gemma-style sqrt(d) embedding scale
    # --- attention blocking (memory-efficient online softmax) ---
    q_block: int = 512
    kv_block: int = 1024
    # --- distribution perf knobs (§Perf; defaults = paper-faithful baseline)
    # Megatron-SP-style sequence-sharded residual stream: row-parallel block
    # outputs reduce-scatter to an S-sharded residual (half the wire of an
    # all-reduce) and re-gather only at the next projection; norms are
    # per-token so S-sharding is exact.
    seq_shard_residual: bool = False

    # ----- derived -----
    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        return round_up(self.vocab_size, self.vocab_round)

    @property
    def is_subquadratic(self) -> bool:
        """Eligible for the long_500k shape (see DESIGN.md §3)."""
        if self.family in ("zamba", "xlstm"):
            return True
        full_attn_layers = (self.local_global_period == 0 and self.sliding_window == 0)
        return not full_attn_layers and self.local_global_period == 0

    def with_(self, **kw) -> "ModelConfig":
        return replace(self, **kw)


def reduce_for_smoke(cfg: ModelConfig) -> ModelConfig:
    """Shrink a config to CPU-smoke size while preserving its family traits.

    Keeps every structural feature (MoE, MLA, softcaps, window alternation,
    hybrid periods) but cuts width/depth/vocab so one train step runs in
    seconds on a single CPU core.
    """
    kw: dict = dict(
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 4) if cfg.n_kv_heads else 4,
        d_ff=256,
        vocab_size=512,
        head_dim=32,
        q_block=32,
        kv_block=32,
        vocab_round=64,
    )
    if cfg.family == "encdec":
        kw.update(n_enc_layers=2, n_dec_layers=2, n_layers=4, enc_memory_len=32)
    elif cfg.family == "zamba":
        kw.update(n_layers=6, attn_every=3)
    elif cfg.family == "xlstm":
        kw.update(n_layers=4)
    else:
        kw.update(n_layers=2)
    if cfg.moe is not None:
        # capacity_factor 8: smoke tests check serving-vs-training logit
        # consistency, which capacity drops would legitimately break
        kw["moe"] = MoEConfig(
            n_experts=min(cfg.moe.n_experts, 4), top_k=cfg.moe.top_k,
            d_ff=128,
            n_shared_experts=cfg.moe.n_shared_experts,
            shared_d_ff=128 if cfg.moe.n_shared_experts else 0,
            capacity_factor=8.0)
    if cfg.mla is not None:
        kw["mla"] = MLAConfig(q_lora_rank=48, kv_lora_rank=32,
                              qk_nope_head_dim=16, qk_rope_head_dim=16,
                              v_head_dim=32)
        kw["head_dim"] = 32
    if cfg.ssm is not None:
        kw["ssm"] = SSMConfig(d_state=16, head_dim=16, expand=2,
                              conv_kernel=4, chunk=16)
    if cfg.xlstm is not None:
        kw["xlstm"] = XLSTMConfig(slstm_every=cfg.xlstm.slstm_every, chunk=8)
    if cfg.sliding_window:
        kw["sliding_window"] = 64
    if cfg.vision_tokens:
        kw["vision_tokens"] = 8
    if cfg.mrope:
        # rescale the t/h/w frequency split to the reduced head_dim (32 -> 16 slots)
        kw["mrope_sections"] = (4, 6, 6)
    return cfg.with_(**kw)
