"""Model configuration schema covering all assigned architecture families."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str            # dense | moe | hybrid | ssm | encdec | vlm | audio
    num_layers: int        # decoder layers for enc-dec
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # --- MLP flavor ---
    mlp_type: str = "swiglu"   # swiglu | gelu (2-matrix) | relu (2-matrix)

    # --- MoE ---
    moe_num_experts: int = 0   # routed experts (0 => dense)
    moe_top_k: int = 0
    moe_num_shared: int = 0    # always-on shared experts
    moe_d_ff: int = 0          # per-expert hidden dim (fine-grained MoE)
    moe_every: int = 1         # MoE replaces dense MLP every Nth layer
    moe_capacity_factor: float = 1.5

    # --- attention flavor ---
    rope_theta: float = 10000.0
    window_size: int = 0         # >0: sliding-window (local) attention
    alt_local_global: bool = False  # gemma2: even layers local, odd global
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0
    qkv_bias: bool = False

    # --- hybrid / ssm ---
    attn_every: int = 1        # jamba: layer i is attention iff i % attn_every == 0
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    mamba_dt_rank: int = 0     # 0 => ceil(d_model / 16)
    xlstm: bool = False        # alternate mLSTM (even) / sLSTM (odd) blocks

    # --- encoder-decoder ---
    encoder_layers: int = 0    # >0 => enc-dec; num_layers is the decoder

    # --- modality stub ---
    modality: str = "text"     # text | audio_frames | vision_patches
    num_prefix_embeds: int = 0  # frontend-provided embeddings prepended

    # --- misc ---
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    scan_period: int = 1       # layers per scanned super-block
    dtype: str = "bfloat16"

    def __post_init__(self):
        if self.num_layers % self.scan_period != 0:
            raise ValueError("num_layers must be divisible by scan_period")
        if self.encoder_layers and self.family not in ("encdec", "audio"):
            raise ValueError("encoder_layers requires encdec/audio family")

    # ---- derived ----

    @property
    def num_periods(self) -> int:
        return self.num_layers // self.scan_period

    @property
    def d_inner(self) -> int:
        return self.mamba_expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return self.mamba_dt_rank or -(-self.d_model // 16)

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    def layer_kind(self, i: int) -> str:
        """Sub-layer mixer kind for layer i: attn | mamba | mlstm | slstm."""
        if self.xlstm:
            return "mlstm" if i % 2 == 0 else "slstm"
        if self.attn_every > 1:
            return "attn" if i % self.attn_every == 0 else "mamba"
        return "attn"

    def layer_is_moe(self, i: int) -> bool:
        if self.moe_num_experts == 0:
            return False
        return (i % self.moe_every) == (self.moe_every - 1)

    def layer_is_local_attn(self, i: int) -> bool:
        if not self.alt_local_global:
            return self.window_size > 0
        return i % 2 == 0  # gemma2: even layers sliding-window

    @property
    def uses_kv_cache(self) -> bool:
        return any(
            self.layer_kind(i) == "attn" for i in range(self.num_layers)
        )

    def period_kinds(self) -> tuple[str, ...]:
        """Kind signature of one scan super-block (must tile num_layers)."""
        kinds = tuple(
            (
                self.layer_kind(i),
                self.layer_is_moe(i),
                self.layer_is_local_attn(i),
            )
            for i in range(self.scan_period)
        )
        # verify the pattern is truly periodic
        for i in range(self.num_layers):
            j = i % self.scan_period
            if (
                self.layer_kind(i),
                self.layer_is_moe(i),
                self.layer_is_local_attn(i),
            ) != kinds[j]:
                raise ValueError(
                    f"layer pattern not periodic with scan_period="
                    f"{self.scan_period} at layer {i}"
                )
        return kinds

    def active_params_per_token(self) -> float:
        """~active params for 6ND MODEL_FLOPS accounting (dense: all)."""
        return count_params(self, active_only=True)

    def total_params(self) -> float:
        return count_params(self, active_only=False)


def count_params(cfg: ModelConfig, active_only: bool = False) -> float:
    """Closed-form parameter count (matches init; used for roofline 6ND)."""
    d = cfg.d_model
    emb = cfg.vocab_size * d
    total = emb * (1 if cfg.tie_embeddings else 2)
    total += d  # final_norm
    if cfg.num_prefix_embeds or cfg.encoder_layers:
        total += d * d  # modality adapter / encoder input projection

    def attn_params():
        p = d * cfg.q_dim + d * cfg.kv_dim * 2 + cfg.q_dim * d
        if cfg.qkv_bias:
            p += cfg.q_dim + 2 * cfg.kv_dim
        return p

    def mlp_params(hidden):
        n_mat = 3 if cfg.mlp_type == "swiglu" else 2
        return n_mat * d * hidden

    def mamba_params():
        di, n, r = cfg.d_inner, cfg.mamba_d_state, cfg.dt_rank
        return (
            d * 2 * di          # in_proj (x, z)
            + cfg.mamba_d_conv * di + di  # depthwise conv (w, b)
            + di * (r + 2 * n)  # x_proj
            + r * di + di       # dt_proj, dt_bias
            + di * n + di       # A_log, D
            + di * d            # out_proj
        )

    def mlstm_params():
        di = 2 * d
        h = cfg.num_heads
        # up(x,z), qkv, i/f gates (+biases), down
        return d * 2 * di + 3 * d * d + d * 2 * h + 2 * h + di * d

    def slstm_params():
        dh = d // max(cfg.num_heads, 1)
        # w_gates, recurrent block-diag, gate biases, out_proj
        return 4 * d * d + 4 * dh * d + 4 * d + d * d

    for i in range(cfg.num_layers):
        kind = cfg.layer_kind(i)
        if kind == "attn":
            total += attn_params()
            if cfg.encoder_layers:
                total += attn_params() + d  # decoder cross-attn + its norm
        elif kind == "mamba":
            total += mamba_params()
        elif kind == "mlstm":
            total += mlstm_params()
        elif kind == "slstm":
            total += slstm_params()
        total += 2 * d  # norms
        if cfg.layer_is_moe(i):
            hidden = cfg.moe_d_ff or cfg.d_ff
            routed = cfg.moe_num_experts * mlp_params(hidden)
            shared = cfg.moe_num_shared * mlp_params(hidden)
            router = d * cfg.moe_num_experts
            if active_only:
                routed = cfg.moe_top_k * mlp_params(hidden)
            total += routed + shared + router
        elif cfg.d_ff > 0:
            total += mlp_params(cfg.d_ff)
        # xlstm blocks (d_ff = 0) have no separate MLP
    for i in range(cfg.encoder_layers):
        total += attn_params() + mlp_params(cfg.d_ff) + 2 * d
    if cfg.encoder_layers:
        total += d  # enc_norm
    return float(total)
