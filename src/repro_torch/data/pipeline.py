"""Synthetic LM data pipeline: deterministic, shardable, exactly resumable
— a copy of ``repro.data.pipeline`` (numpy's Philox on the host), whose
tokens are byte-identical to the reference's for every (seed, step, shard).

Every batch is a pure function of (seed, step, shard), so a restart at step
k reproduces the identical stream, each data-parallel rank generates only
its shard, and a checkpoint stores just ``DataState(step)``.  The tokens are
Zipfian with a periodic repeat the model can learn, so the loss decreases
in the example runs (uniform tokens would pin it at log V).
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["DataConfig", "DataState", "SyntheticLM", "make_global_batch"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2          # skew of the unigram distribution
    markov_period: int = 16      # repeat structure the model can learn
    ignore_id: int = -1


@dataclasses.dataclass
class DataState:
    step: int = 0

    def as_dict(self):
        return {"step": self.step}

    @classmethod
    def from_dict(cls, d):
        return cls(step=int(d["step"]))


class SyntheticLM:
    """Host-side generator; one instance per process."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        p = 1.0 / ranks**cfg.zipf_a
        self._p = p / p.sum()

    def batch_for(self, step: int, shard: int = 0, n_shards: int = 1):
        """(tokens, labels) int32 numpy arrays for this rank's slice of the
        global batch; labels are the tokens shifted left, the last
        ``ignore_id``."""
        cfg = self.cfg
        if cfg.global_batch % n_shards:
            raise ValueError(f"global batch {cfg.global_batch} does not split "
                             f"into {n_shards} shards")
        local = cfg.global_batch // n_shards
        rng = np.random.Generator(
            np.random.Philox(key=cfg.seed, counter=[0, 0, step, shard]))
        base = rng.choice(cfg.vocab_size, size=(local, cfg.seq_len), p=self._p)
        # every markov_period-th token repeats the sequence-initial token
        period = cfg.markov_period
        base[:, period::period] = base[:, :1]
        tokens = base.astype(np.int32)
        labels = np.roll(tokens, -1, axis=1)
        labels[:, -1] = cfg.ignore_id
        return tokens, labels


def make_global_batch(cfg: DataConfig, step: int):
    """The full (unsharded) batch, for single-host tests."""
    return SyntheticLM(cfg).batch_for(step, 0, 1)
