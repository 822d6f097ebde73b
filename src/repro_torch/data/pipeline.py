"""Synthetic data pipeline (numpy only; the JAX package's
``data/pipeline.py``, copied so that the port imports nothing of it).

Deterministic per (seed, step, host) so restarts resume mid-epoch without
state files; per-host slicing mirrors a production loader (each host
materialises only its shard of the global batch). Token streams are
Zipf-distributed with document boundaries (EOS resets): enough structure
for loss curves to be meaningful. Batches are numpy arrays; the trainer
moves them to its device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class PipelineConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.3
    doc_len_mean: int = 512
    eos_id: int = 1


class TokenPipeline:
    def __init__(self, cfg: PipelineConfig, host_id: int = 0,
                 n_hosts: int = 1):
        assert cfg.global_batch % n_hosts == 0
        self.cfg = cfg
        self.host_id = host_id
        self.n_hosts = n_hosts
        self.host_batch = cfg.global_batch // n_hosts

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            (self.cfg.seed, step, self.host_id))

    def batch(self, step: int) -> dict:
        """{"tokens", "labels"}: int32 [host_batch, seq_len], the labels
        the tokens shifted by one."""
        cfg = self.cfg
        rng = self._rng(step)
        n = self.host_batch * (cfg.seq_len + 1)
        toks = rng.zipf(cfg.zipf_a, size=n).astype(np.int64)
        toks = (toks % (cfg.vocab - 2)) + 2          # reserve 0=pad, 1=eos
        # Document boundaries.
        n_docs = max(n // cfg.doc_len_mean, 1)
        cuts = rng.integers(0, n, size=n_docs)
        toks[cuts] = cfg.eos_id
        toks = toks.reshape(self.host_batch, cfg.seq_len + 1)
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}

    def modality_stub(self, step: int, n_tokens: int, d_model: int,
                      kind: str = "vision") -> np.ndarray:
        """Precomputed frontend embeddings (the vlm / audio stub), f32
        [host_batch, n_tokens, d_model]."""
        rng = self._rng(step * 7919 + (0 if kind == "vision" else 1))
        return rng.normal(0.0, 0.3, size=(
            self.host_batch, n_tokens, d_model)).astype(np.float32)


def batch_for(cfg, shape, step: int = 0, seed: int = 0,
              reduced_batch: Optional[int] = None) -> dict:
    """Full batch dict for (arch config, input shape), stubs included.
    ``reduced_batch`` overrides the shape's global batch (small runs)."""
    gb = reduced_batch or shape.global_batch
    pipe = TokenPipeline(PipelineConfig(cfg.vocab, shape.seq_len, gb,
                                        seed=seed))
    b = pipe.batch(step)
    if cfg.family == "vlm":
        b["vision_embeds"] = pipe.modality_stub(step, cfg.n_vision_tokens,
                                                cfg.d_model)
    if cfg.family == "audio":
        b["audio_embeds"] = pipe.modality_stub(step, shape.seq_len,
                                               cfg.d_model, kind="audio")
    return b
