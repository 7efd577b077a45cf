"""Deterministic, resumable synthetic data pipeline with BitWeaving-based
document filtering (the paper's Section 8.2 workload embedded in the LM
data path).

Design for fault tolerance: batches are a pure function of the step index
(`batch_at(step)`), so resuming after a failure needs only the step number
from the checkpoint manifest - no iterator state, no data loss, identical
batches on replay. Sharding: each data-parallel shard slices its rows from
the global batch deterministically. The streams are numpy, the same
arrays as the reference's for the same seed and step.

The synthetic corpus is a mixture of "documents" with metadata columns
(quality score, length, language id). The pipeline bit-slices the metadata
on the device and evaluates the selection predicate (q1 <= quality <= q2
AND len >= L) with the BitWeaving scan kernel (two launches on the card)
and a bitwise AND.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from ..core.bitvector import resolve_device, unpack_bits
from ..kernels import ops, ref


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    # structured-sequence params (makes loss learnable: next token is a
    # deterministic function of the previous two plus noise)
    noise: float = 0.05


class SyntheticLM:
    """Stateless synthetic LM stream: batch_at(step) is pure."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def batch_at(self, step: int, shard: int = 0, n_shards: int = 1
                 ) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        b = cfg.global_batch // n_shards
        rng = np.random.default_rng(
            np.uint64(cfg.seed * 1_000_003 + step * 65_537 + shard))
        s = cfg.seq_len + 1
        # Markov-ish structure: x[t] = (a*x[t-1] + b*x[t-2] + c) % vocab
        a = rng.integers(1, 7, size=(b, 1))
        c = rng.integers(0, cfg.vocab, size=(b, 1))
        x = np.zeros((b, s), np.int64)
        x[:, 0] = rng.integers(0, cfg.vocab, size=b)
        x[:, 1] = rng.integers(0, cfg.vocab, size=b)
        for t in range(2, s):
            x[:, t] = (a[:, 0] * x[:, t - 1] + x[:, t - 2] + c[:, 0]) \
                % cfg.vocab
        noise_mask = rng.random((b, s)) < cfg.noise
        x = np.where(noise_mask, rng.integers(0, cfg.vocab, size=(b, s)), x)
        return {"tokens": x[:, :-1].astype(np.int32),
                "labels": x[:, 1:].astype(np.int32)}


# ---------------------------------------------------------------------------
# BitWeaving document filter (the scan kernel in the data path)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CorpusMeta:
    """Bit-sliced metadata columns for n documents."""

    quality: np.ndarray  # (n,) uint8  0..255
    length: np.ndarray   # (n,) uint16 in tokens
    lang: np.ndarray     # (n,) uint8 language id


def synth_corpus_meta(n_docs: int, seed: int = 0) -> CorpusMeta:
    rng = np.random.default_rng(seed)
    return CorpusMeta(
        quality=rng.integers(0, 256, n_docs).astype(np.uint16),
        length=rng.integers(0, 4096, n_docs).astype(np.uint16),
        lang=rng.integers(0, 16, n_docs).astype(np.uint16),
    )


def filter_documents(meta: CorpusMeta, q_min: int, q_max: int,
                     len_min: int, use_kernel: bool = True,
                     device=None) -> np.ndarray:
    """Selection mask via BitWeaving predicate scans + bulk AND.

    Returns a boolean (n_docs,) numpy mask. The columns are bit-sliced on
    ``device`` (the card unless named; 32 docs a word); on the card
    ``use_kernel`` runs each scan as one launch of the scan kernel, else
    the plain scan; the combine is one bitwise AND."""
    dev = resolve_device(device)
    n = len(meta.quality)
    pad = (-n) % 32
    q = np.pad(meta.quality, (0, pad)).astype(np.int32)
    ln = np.pad(meta.length, (0, pad)).astype(np.int32)
    qp = ref.bitslice(torch.from_numpy(q).to(dev), 8)
    lp = ref.bitslice(torch.from_numpy(ln).to(dev), 12)
    scan = ops.bitweaving_scan if use_kernel else ref.bitweaving_scan
    both = scan(qp, q_min, q_max) & scan(lp, len_min, 4095)
    return unpack_bits(both, n).cpu().numpy()


class FilteredSyntheticLM(SyntheticLM):
    """SyntheticLM whose per-step document ids pass the BitWeaving filter
    (the scan kernel in the ingest path; selection is still a pure
    function of (seed, predicate) so resume determinism holds)."""

    def __init__(self, cfg: DataConfig, n_docs: int = 4096,
                 q_min: int = 64, q_max: int = 250, len_min: int = 256,
                 device=None):
        super().__init__(cfg)
        self.meta = synth_corpus_meta(n_docs, cfg.seed)
        self.mask = filter_documents(self.meta, q_min, q_max, len_min,
                                     device=device)
        self.doc_ids = np.nonzero(self.mask)[0]
        if len(self.doc_ids) == 0:
            raise ValueError("filter selected zero documents")

    def batch_at(self, step: int, shard: int = 0, n_shards: int = 1):
        batch = super().batch_at(step, shard, n_shards)
        rng = np.random.default_rng(np.uint64(self.cfg.seed + step))
        b = batch["tokens"].shape[0]
        batch["doc_ids"] = rng.choice(self.doc_ids, size=b).astype(np.int32)
        return batch
