"""whisper-base [audio]: enc-dec, 6L(+6L enc) d_model=512 8H d_ff=2048
vocab=51865, conv frontend STUB (precomputed frame embeddings).
[arXiv:2212.04356]"""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base", family="encdec",
    n_layers=6, enc_layers=6, enc_seq=1500,
    d_model=512, n_heads=8, n_kv_heads=8, d_ff=2048,
    vocab_size=51865,
    rope_style="none", norm="layernorm", mlp="gelu",
    tie_embeddings=True, frontend="audio",
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, enc_layers=2, enc_seq=32, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=128, vocab_size=512)
