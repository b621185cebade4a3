"""Configuration for the PyTorch port.

Copies of the JAX package's ``MemForestConfig``, ``ModelConfig`` and
``TrainConfig`` with the same fields and defaults, so both packages build the
same forest, the same model and the same trainer from the same settings.
``ModelConfig`` has no ``attention_impl``: in the port the device of the
tensors chooses between a CUDA kernel and its plain PyTorch version.
``TrainConfig.zero1`` is kept for the copy's sake: on a model mesh the
moments are always placed by ``zero1_shardings``
(``training.train_loop.shard_train_state``), as the reference's
``dryrun.build_cell`` places them whatever the field says.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class MemForestConfig:
    """Paper defaults (Sections 4, 6; Appendix C)."""

    chunk_turns: int = 2            # b = 2 (Appendix C operating point)
    branching_factor: int = 8       # k; Fig. 6d/e knee is moderate (<=16)
    embed_dim: int = 256
    canonical_sim_threshold: float = 0.92
    scene_sim_threshold: float = 0.60
    forest_recall_topk: int = 8     # trees recalled per query
    fact_recall_topk: int = 16      # facts for fact->tree recall
    final_topk: int = 10            # paper: final retrieval budget top-10
    browse_beam: int = 2            # children expanded per level
    browse_mode: str = "llm+planner"  # flat | root-only | emb | emb+planner | llm | llm+planner
    tree_families: Tuple[str, ...] = ("entity", "scene", "session")
    lazy_refresh: bool = True
    level_parallel: bool = True
    # defer the dirty-path flush past ingestion entirely: summaries refresh
    # on the first query that needs them (LSM-style read-triggered
    # compaction). Minimizes write latency; first-read pays the flush.
    read_triggered_refresh: bool = False
    max_nodes_per_tree: int = 4096
    encoder: str = "hashing"        # hashing | model


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description.

    ``family`` selects the block type, and the port runs every one:
    ``dense`` (pre-norm GQA transformer, RoPE, SwiGLU / GeLU / relu^2 MLP),
    ``moe`` (the same attention, a top-k routed expert MLP), ``vlm`` (dense,
    with patch embeddings prepended to the tokens), ``encdec`` (whisper:
    a bidirectional encoder, a decoder with cross-attention), ``ssm``
    (rwkv6) and ``hybrid`` (zamba2).
    """

    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads

    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25

    # --- SSM / hybrid ---
    ssm_state_dim: int = 0          # Mamba2 N (state size per head)
    ssm_head_dim: int = 64          # Mamba2 P (channels per head)
    ssm_expand: int = 2             # d_inner = expand * d_model
    ssm_conv_width: int = 4
    attn_every: int = 0             # hybrid: shared attention every k blocks
    rwkv_head_size: int = 64

    # --- enc-dec / vlm frontends (stubs provide embeddings directly) ---
    encoder_layers: int = 0
    encoder_seq_len: int = 1500     # whisper audio frames after conv stub
    num_patches: int = 64           # pixtral patch embeddings prepended

    # --- positional / numerics ---
    rope_theta: float = 500000.0
    max_seq_len: int = 32768
    norm_eps: float = 1e-5
    mlp_activation: str = "swiglu"  # swiglu | gelu | relu2
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"

    # --- execution ---
    scan_layers: bool = True
    remat: bool = True
    logits_softcap: float = 0.0
    moe_fsdp_params: bool = True

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        assert self.num_heads % max(self.num_kv_heads, 1) == 0, (
            f"{self.name}: num_heads {self.num_heads} not divisible by "
            f"num_kv_heads {self.num_kv_heads}"
        )

    # ---- derived quantities ---------------------------------------------
    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic archs that run the long_500k shape."""
        return self.family in ("ssm", "hybrid")

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def d_ff_rwkv(self) -> int:
        return self.d_ff

    def param_count(self, active_only: bool = False) -> int:
        """Analytic parameter count."""
        V, D, L, F = self.vocab_size, self.d_model, self.num_layers, self.d_ff
        emb = V * D * (1 if self.tie_embeddings else 2)
        if self.family in ("dense", "vlm"):
            attn = D * self.q_dim + 2 * D * self.kv_dim + self.q_dim * D
            mlp = 3 * D * F if self.mlp_activation == "swiglu" else 2 * D * F
            per_layer = attn + mlp + 2 * D
            return emb + L * per_layer + D
        if self.family == "moe":
            attn = D * self.q_dim + 2 * D * self.kv_dim + self.q_dim * D
            n_e = self.experts_per_token if active_only else self.num_experts
            mlp = 3 * D * F * n_e + D * self.num_experts  # experts + router
            per_layer = attn + mlp + 2 * D
            return emb + L * per_layer + D
        if self.family == "ssm":  # rwkv6
            H = D // self.rwkv_head_size
            tmix = 4 * D * D + D * D  # r,k,v,o + gate
            decay_lora = 2 * D * 64 + 5 * D * 32  # w lora + ddlerp towers
            cmix = 2 * D * self.d_ff_rwkv
            per_layer = tmix + decay_lora + cmix + 4 * D + H * self.rwkv_head_size
            return emb + L * per_layer + 2 * D
        if self.family == "hybrid":  # zamba2
            Din, N = self.d_inner, self.ssm_state_dim
            H = Din // self.ssm_head_dim
            in_proj = D * (2 * Din + 2 * H * N + H)
            out_proj = Din * D
            conv = self.ssm_conv_width * (Din + 2 * H * N)
            per_mamba = in_proj + out_proj + conv + 2 * H + Din + 2 * D
            attn = D * self.q_dim + 2 * D * self.kv_dim + self.q_dim * D
            shared_mlp = 3 * D * self.d_ff
            n_attn_apps = self.num_layers // max(self.attn_every, 1)
            shared = attn + shared_mlp + 2 * D  # one set of shared weights
            return emb + L * per_mamba + shared + D + n_attn_apps * 2 * D
        if self.family == "encdec":
            attn = D * self.q_dim + 2 * D * self.kv_dim + self.q_dim * D
            mlp = 2 * D * F  # gelu
            enc = self.encoder_layers * (attn + mlp + 2 * D)
            dec = L * (2 * attn + mlp + 3 * D)  # self + cross attn
            return emb + enc + dec + 2 * D
        raise ValueError(self.family)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    microbatch_size: int = 0          # 0 = no microbatching
    zero1: bool = True                # shard optimizer states over data axes
    grad_compression: str = "none"    # none | topk | int8
    compression_ratio: float = 0.125  # for topk
    checkpoint_every: int = 100
    checkpoint_dir: str = "/tmp/repro_ckpt"
    seed: int = 0


@dataclass(frozen=True)
class ShapeConfig:
    """One input shape of an LM family: its size and which step it runs."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def is_train(self) -> bool:
        return self.kind == "train"
