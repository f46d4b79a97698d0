"""Feed-forward blocks (mirrors ``repro/models/mlp.py``)."""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from repro_torch.models.layers import act_fn, dense_apply, dense_init


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    d_model: int
    d_ff: int
    gated: bool = True
    act: str = "silu"
    bias: bool = False


def mlp_init(gen, cfg: MLPConfig, dtype=torch.float32, lead: Tuple[int, ...] = ()):
    sd_in, sd_out = 1.0 / math.sqrt(cfg.d_model), 1.0 / math.sqrt(cfg.d_ff)
    kw = dict(bias=cfg.bias, dtype=dtype, lead=lead)
    if cfg.gated:
        return {
            "gate_proj": dense_init(gen, (cfg.d_model,), (cfg.d_ff,), stddev=sd_in, **kw),
            "up_proj": dense_init(gen, (cfg.d_model,), (cfg.d_ff,), stddev=sd_in, **kw),
            "down_proj": dense_init(gen, (cfg.d_ff,), (cfg.d_model,), stddev=sd_out, **kw),
        }
    return {
        "fc1": dense_init(gen, (cfg.d_model,), (cfg.d_ff,), stddev=sd_in, **kw),
        "fc2": dense_init(gen, (cfg.d_ff,), (cfg.d_model,), stddev=sd_out, **kw),
    }


def mlp_apply(p, x, *, cfg: MLPConfig, compute_dtype=torch.bfloat16):
    f = act_fn(cfg.act)
    if cfg.gated:
        g = dense_apply(p["gate_proj"], x, compute_dtype=compute_dtype)
        u = dense_apply(p["up_proj"], x, compute_dtype=compute_dtype)
        return dense_apply(p["down_proj"], f(g) * u, compute_dtype=compute_dtype)
    h = f(dense_apply(p["fc1"], x, compute_dtype=compute_dtype))
    return dense_apply(p["fc2"], h, compute_dtype=compute_dtype)
