"""Deterministic synthetic token pipeline — numpy copy of
``repro.data.pipeline``, so both packages draw identical batches.

Every batch derives from (seed, step) alone: the pipeline's state is the
step counter, stored in checkpoints, so a restart resumes the data order
exactly.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass
class PipelineState:
    seed: int
    step: int


class SyntheticLM:
    """Markov-ish token stream with enough structure that loss decreases.

    Tokens follow a noisy arithmetic progression per sequence; labels are
    the next token.  ``loss_mask`` is all ones.  Batches are numpy arrays
    (dense family: tokens, labels, loss_mask).
    """

    def __init__(self, cfg: ModelConfig, batch: int, seq: int, seed: int = 0):
        if cfg.family != "dense":
            raise NotImplementedError(
                f"family {cfg.family!r}: the port's pipeline makes dense-"
                f"family batches; vlm/audio inputs are slice 4")
        self.cfg, self.batch, self.seq = cfg, batch, seq
        self.state = PipelineState(seed=seed, step=0)

    def save_state(self) -> Dict:
        return dataclasses.asdict(self.state)

    def restore_state(self, d: Dict) -> None:
        self.state = PipelineState(**d)

    def next_batch(self) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            (self.state.seed * 1_000_003 + self.state.step) % (2 ** 63))
        self.state.step += 1
        v = self.cfg.vocab_size
        start = rng.integers(0, v, (self.batch, 1))
        stride = rng.integers(1, 7, (self.batch, 1))
        pos = np.arange(self.seq + 1)[None, :]
        toks = (start + stride * pos) % v
        noise = rng.integers(0, v, toks.shape)
        keep = rng.random(toks.shape) > 0.05
        toks = np.where(keep, toks, noise).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:],
                "loss_mask": np.ones((self.batch, self.seq), np.float32)}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next_batch()
