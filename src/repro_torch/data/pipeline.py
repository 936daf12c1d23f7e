"""Deterministic synthetic LM data pipeline, host-sharded: a copy of the
JAX package's ``data/pipeline.py`` (numpy only), so every batch is
byte-equal to the JAX package's for the same step, host and config.

Sequences follow a learnable noisy affine token process
(t_{i+1} = (a*t_i + c) mod V with epsilon-noise), so small models show
clearly decreasing loss, while the pipeline stays bit-deterministic
across restarts (a restart resumes mid-epoch by step index alone).

For multi-host training each host generates only its shard:
``Pipeline(..., host_id=h, num_hosts=n)`` -- the global batch is
partitioned by rows.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    noise: float = 0.05
    a: int = 31
    c: int = 7


class Pipeline:
    def __init__(self, cfg: DataConfig, host_id: int = 0,
                 num_hosts: int = 1):
        assert cfg.global_batch % num_hosts == 0
        self.cfg = cfg
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.local_batch = cfg.global_batch // num_hosts

    def batch(self, step: int) -> dict:
        """Batch for global ``step`` (stateless => restartable):
        {"tokens": (local_batch, seq_len) int32}, numpy."""
        cfg = self.cfg
        rows = []
        base = step * cfg.global_batch + self.host_id * self.local_batch
        for r in range(self.local_batch):
            rng = np.random.default_rng(base + r)
            t = np.empty(cfg.seq_len, np.int32)
            t[0] = rng.integers(0, cfg.vocab_size)
            noise = rng.random(cfg.seq_len) < cfg.noise
            rand = rng.integers(0, cfg.vocab_size, cfg.seq_len)
            for i in range(1, cfg.seq_len):
                t[i] = rand[i] if noise[i] else \
                    (cfg.a * t[i - 1] + cfg.c) % cfg.vocab_size
            rows.append(t)
        return {"tokens": np.stack(rows)}
