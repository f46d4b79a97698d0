"""Deterministic synthetic datasets — a copy of ``repro/data/synthetic.py``
(numpy only; the port imports nothing of the JAX package, and importing that
module would run ``repro/data/__init__.py``).  The same config and step give
the same batches as the JAX package's.

Design constraints (production data-pipeline semantics at 1000-node scale):
  * deterministic in (seed, step, host_id) — a replacement host resumes a
    dead host's shard stream exactly (straggler/fault recovery);
  * iterator state is a tiny dict (step counter) stored in checkpoints;
  * per-host sharding by construction (no global shuffle state).

LM stream: a noisy affine Markov chain over the vocab — next = (a·cur + c)
mod V with prob 1-ε else uniform.  Cross-entropy has a known floor
(≈ -[(1-ε)·log(1-ε+ε/V) + ε·log(ε/V)]), so training curves are checkable.

Image stream: per-class deterministic low-frequency template + Gaussian
noise; linearly separable at high SNR, CNN-learnable in a few hundred steps.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np


@dataclasses.dataclass(frozen=True)
class SyntheticLMConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    n_hosts: int = 1
    host_id: int = 0
    seed: int = 0
    noise: float = 0.1
    mult: int = 31
    offset: int = 17


class SyntheticLM:
    """Checkpointable deterministic LM token stream."""

    def __init__(self, cfg: SyntheticLMConfig, step: int = 0):
        assert cfg.global_batch % cfg.n_hosts == 0
        self.cfg = cfg
        self.step = step

    @property
    def host_batch(self) -> int:
        return self.cfg.global_batch // self.cfg.n_hosts

    def state_dict(self) -> Dict[str, int]:
        return {"step": self.step}

    def load_state_dict(self, state: Dict[str, int]) -> None:
        self.step = int(state["step"])

    def _rng(self, step: int) -> np.random.Generator:
        c = self.cfg
        return np.random.default_rng(
            np.random.SeedSequence([c.seed, step, c.host_id])
        )

    def peek(self, step: int) -> Dict[str, np.ndarray]:
        c = self.cfg
        rng = self._rng(step)
        B, T, V = self.host_batch, c.seq_len, c.vocab_size
        toks = np.empty((B, T), np.int32)
        toks[:, 0] = rng.integers(0, V, size=B)
        noise_mask = rng.random((B, T - 1)) < c.noise
        noise_tok = rng.integers(0, V, size=(B, T - 1))
        for t in range(1, T):
            nxt = (toks[:, t - 1].astype(np.int64) * c.mult + c.offset) % V
            toks[:, t] = np.where(noise_mask[:, t - 1], noise_tok[:, t - 1], nxt)
        return {"tokens": toks}

    def __next__(self) -> Dict[str, np.ndarray]:
        batch = self.peek(self.step)
        self.step += 1
        return batch

    def __iter__(self):
        return self

    def ce_floor(self) -> float:
        """Bayes-optimal next-token cross entropy of the stream."""
        c = self.cfg
        eps, V = c.noise, c.vocab_size
        p_correct = (1 - eps) + eps / V
        p_other = eps / V
        return float(-(p_correct * np.log(p_correct) + (V - 1) * p_other * np.log(p_other)))


@dataclasses.dataclass(frozen=True)
class SyntheticImagesConfig:
    n_classes: int
    hw: int = 32
    channels: int = 3
    global_batch: int = 64
    n_hosts: int = 1
    host_id: int = 0
    seed: int = 0
    snr: float = 2.0  # template amplitude / noise sigma


class SyntheticImages:
    """Checkpointable deterministic image-classification stream."""

    def __init__(self, cfg: SyntheticImagesConfig, step: int = 0):
        assert cfg.global_batch % cfg.n_hosts == 0
        self.cfg = cfg
        self.step = step
        self.templates = self._make_templates()

    @property
    def host_batch(self) -> int:
        return self.cfg.global_batch // self.cfg.n_hosts

    def _make_templates(self) -> np.ndarray:
        c = self.cfg
        rng = np.random.default_rng(np.random.SeedSequence([c.seed, 9999]))
        # low-frequency class templates: random 4x4 upsampled to hw
        small = rng.normal(size=(c.n_classes, 4, 4, c.channels))
        reps = c.hw // 4
        t = np.repeat(np.repeat(small, reps, axis=1), reps, axis=2)
        return (t * c.snr).astype(np.float32)

    def state_dict(self) -> Dict[str, int]:
        return {"step": self.step}

    def load_state_dict(self, state: Dict[str, int]) -> None:
        self.step = int(state["step"])

    def peek(self, step: int) -> Dict[str, np.ndarray]:
        c = self.cfg
        rng = np.random.default_rng(np.random.SeedSequence([c.seed, step, c.host_id]))
        B = self.host_batch
        labels = rng.integers(0, c.n_classes, size=B).astype(np.int32)
        noise = rng.normal(size=(B, c.hw, c.hw, c.channels)).astype(np.float32)
        images = self.templates[labels] + noise
        return {"images": images, "labels": labels}

    def __next__(self) -> Dict[str, np.ndarray]:
        batch = self.peek(self.step)
        self.step += 1
        return batch

    def __iter__(self):
        return self
