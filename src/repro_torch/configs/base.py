"""Training configuration (the ETL + DLRM slice needs only TrainConfig)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: str = "adamw"  # adamw (adafactor is not ported yet)
    lr: float = 3e-4
    weight_decay: float = 0.01
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    opt_state_dtype: str = "float32"
    microbatch: int = 0  # grad-accumulation chunks (0/1 = off; >1 not ported)
    max_grad_norm: float = 1.0
