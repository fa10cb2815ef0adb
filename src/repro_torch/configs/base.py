"""Model / training configuration dataclasses (copies of the JAX package's;
``pdtype`` / ``cdtype`` return torch dtypes)."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    first_dense_layers: int = 0  # leading dense layers (Kimi-K2 style)


@dataclasses.dataclass(frozen=True)
class SSMCfg:
    d_state: int
    head_dim: int = 64
    expand: int = 2
    d_conv: int = 4
    chunk: int = 128
    n_groups: int = 1


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    qk_norm: bool = False
    rope_style: str = "full"  # full | half | none
    rope_theta: float = 500000.0
    sliding_window: int = 0
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    mlp: str = "swiglu"  # swiglu | gelu
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    moe: Optional[MoECfg] = None
    ssm: Optional[SSMCfg] = None
    # hybrid (zamba2): one shared attention block applied every k-th layer
    shared_attn_period: int = 0
    # enc-dec (whisper)
    enc_layers: int = 0
    enc_seq: int = 1500
    # vlm (internvl2): number of prepended patch embeddings
    n_patches: int = 0
    # modality frontend stub: "audio" | "vision" | "" (none)
    frontend: str = ""
    # dtype policy
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # remat: "none" | "full" | "dots"
    remat: str = "full"
    # Megatron-style sequence parallelism: residuals/saved activations are
    # sequence-sharded over the model axis (allgather before attention/MLP,
    # reduce-scatter after) — activation memory / model_axis
    seq_parallel: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def padded_vocab(self) -> int:
        """Embedding/head rows padded to a 256 multiple so the vocab dim
        shards over the model axis (ids >= vocab_size are masked in the
        loss).  256 = lcm-friendly for 16/32-way model axes + lane width."""
        return -(-self.vocab_size // 256) * 256

    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    def param_count(self) -> int:
        """Analytic parameter count (for 6ND model-flops and memory checks)."""
        d, v, L = self.d_model, self.vocab_size, self.n_layers
        hd = self.hd
        emb = v * d * (1 if self.tie_embeddings else 2)
        if self.family == "ssm":
            di = self.ssm.expand * d
            g, n = self.ssm.n_groups, self.ssm.d_state
            per = (d * (2 * di + 2 * g * n + di // self.ssm.head_dim)
                   + di * d + di)
            return emb + L * per
        attn = d * (self.n_heads * hd) * 2 + d * (self.n_kv_heads * hd) * 2
        if self.moe:
            e = self.moe
            ffn = ((e.n_experts + e.n_shared_experts) * 3 * d * e.d_ff_expert)
            dense_ffn = 3 * d * self.d_ff if e.first_dense_layers else 0
            per = attn + ffn
            total = emb + (L - e.first_dense_layers) * per \
                + e.first_dense_layers * (attn + dense_ffn) \
                + L * d * e.n_experts  # router
            return total
        mult = 3 if self.mlp == "swiglu" else 2
        per = attn + mult * d * self.d_ff
        if self.family == "hybrid":
            di = self.ssm.expand * d
            g, n = self.ssm.n_groups, self.ssm.d_state
            per_m = (d * (2 * di + 2 * g * n + di // self.ssm.head_dim)
                     + di * d)
            shared = attn + mult * d * self.d_ff
            return emb + L * per_m + shared
        if self.family == "encdec":
            # decoder layers carry an extra cross-attention block
            return emb + self.enc_layers * per + L * (per + attn)
        return emb + L * per

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed experts count)."""
        if not self.moe:
            return self.param_count()
        d, L = self.d_model, self.n_layers
        e = self.moe
        attn = d * (self.n_heads * self.hd) * 2 + d * (self.n_kv_heads * self.hd) * 2
        act_ffn = (e.top_k + e.n_shared_experts) * 3 * d * e.d_ff_expert
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return emb + L * (attn + act_ffn + d * e.n_experts)


@dataclasses.dataclass(frozen=True)
class ShapeCfg:
    """One (input-shape) cell: training or serving geometry."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


TRAIN_4K = ShapeCfg("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeCfg("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeCfg("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeCfg("long_500k", 524288, 1, "decode")
ALL_SHAPES = [TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: str = "adamw"  # adamw | adafactor
    lr: float = 3e-4
    weight_decay: float = 0.01
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    opt_state_dtype: str = "float32"  # bf16 halves optimizer HBM (405B/1T)
    accum_dtype: str = "float32"  # grad-accumulation dtype (bf16 at 405B/1T)
    microbatch: int = 0  # number of grad-accumulation chunks (0/1 = off)
    grad_compression: str = "none"  # none | int8_ef (no train step reads it)
    fsdp: bool = False  # ZeRO-3 over the data axes (training/train_loop.shard_train_step)
    max_grad_norm: float = 1.0
