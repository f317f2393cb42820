"""Deterministic synthetic LM data pipeline with a persistable cursor
(port of ``repro.data.pipeline``; numpy only, batch for batch the JAX
package's: the same ``SeedSequence([seed, step, host_id])``).

Each host makes only its shard of the global batch (``host_id`` /
``num_hosts``); the cursor (the step count) is saved in checkpoints, so
a restarted job resumes on exactly the next batch.

Synthetic distribution: Zipf-ish token draws plus a planted copy span
(the second half of the span repeats the first), so a model can learn
next-token structure.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class PipelineConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    copy_frac: float = 0.25  # fraction of the sequence that is a copy span


@dataclasses.dataclass
class DataPipeline:
    cfg: PipelineConfig
    step: int = 0
    host_id: int = 0
    num_hosts: int = 1

    @property
    def host_batch(self) -> int:
        assert self.cfg.global_batch % self.num_hosts == 0
        return self.cfg.global_batch // self.num_hosts

    def _gen(self, step: int) -> dict:
        c = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([c.seed, step, self.host_id]))
        b, s = self.host_batch, c.seq_len
        ranks = np.arange(1, c.vocab_size + 1)
        p = 1.0 / ranks
        p /= p.sum()
        toks = rng.choice(c.vocab_size, size=(b, s), p=p).astype(np.int32)
        span = max(2, int(s * c.copy_frac)) // 2 * 2
        half = span // 2
        start = rng.integers(0, s - span + 1)
        toks[:, start + half: start + span] = toks[:, start: start + half]
        labels = np.concatenate(
            [toks[:, 1:], np.full((b, 1), -100, np.int32)], axis=1)
        return {"tokens": toks, "labels": labels}

    def next(self) -> dict:
        """The next batch as numpy int32 arrays ``tokens`` and ``labels``
        (the last label of each row is -100, a padding position)."""
        batch = self._gen(self.step)
        self.step += 1
        return batch

    def state(self) -> dict:
        return {"step": self.step, "seed": self.cfg.seed}

    def restore(self, state: dict) -> None:
        assert state["seed"] == self.cfg.seed, "data seed mismatch on restore"
        self.step = int(state["step"])
