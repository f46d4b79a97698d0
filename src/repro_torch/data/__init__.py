"""Deterministic synthetic data streams (numpy; see ``synthetic.py``)."""
from repro_torch.data.synthetic import (
    SyntheticImages,
    SyntheticImagesConfig,
    SyntheticLM,
    SyntheticLMConfig,
)

__all__ = [
    "SyntheticImages",
    "SyntheticImagesConfig",
    "SyntheticLM",
    "SyntheticLMConfig",
]
