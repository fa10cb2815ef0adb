"""kimi-k2-1t-a32b [moe]: 61L d_model=7168 64H (GQA kv=8) d_ff=2048
vocab=163840, MoE 384 experts top-8 (+1 shared expert, 1 leading dense
layer) — trillion-param MoE. [arXiv:2501.kimi2 paper-table]

Expert-parallel over the model axis (384 % 16 == 0); bf16 everything +
Adafactor-style factored optimizer state for HBM fit (see EXPERIMENTS.md).
"""

import dataclasses

from repro_torch.configs.base import ModelConfig, MoECfg

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, head_dim=112,
    d_ff=2048, vocab_size=163840,
    rope_style="full", rope_theta=50000.0,
    moe=MoECfg(n_experts=384, top_k=8, d_ff_expert=2048,
               n_shared_experts=1, first_dense_layers=1),
    param_dtype="bfloat16",
)  # seq_parallel OFF: §Perf K3 — SP boundary gathers cost more than
   # the activation savings once MoE grouped dispatch owns the reshards


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=3, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=128, vocab_size=512, param_dtype="float32",
        moe=MoECfg(n_experts=8, top_k=2, d_ff_expert=128,
                   n_shared_experts=1, first_dense_layers=1))
