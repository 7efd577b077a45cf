"""Batched serving loop: prefill + decode with fixed batch slots.

Continuous-batching-lite: a fixed number of decode slots; finished
sequences are replaced by queued requests at the next prefill boundary.
Greedy or temperature sampling. This is the host-side loop around the
model's prefill/decode_step, called eagerly on the device the
parameters lie on.

An encoder-decoder model (whisper) prefills over each request's
``frames``, the encoder's input embeddings ``(n_frames, d_model)``:
they are stacked along the slot axis, padded slots taking zeros. A
decoder-only model reads no such field, and a request that gives one, or
an encoder-decoder request without one, raises before any prefill.

Termination contract: EVERY sampled token - including the one sampled
from the prefill logits - is checked against ``eos_id`` before it is
recorded; a request is marked ``done`` the moment it finishes (EOS or
``max_new_tokens`` reached), not in a blanket pass afterwards; and the
decode loop stops as soon as every *real* request is finished - padded
slots of a partial batch never keep it alive. ``decode_steps`` counts
the decode iterations actually executed, so tests (and the serving
metrics) can assert no wasted steps.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..obs import MetricsRegistry


@dataclasses.dataclass
class Request:
    prompt: np.ndarray  # (S,) int32
    max_new_tokens: int = 32
    eos_id: Optional[int] = None
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    frames: Optional[np.ndarray] = None  # (n_frames, d_model): enc-dec only


def _device_of(tree) -> Optional[torch.device]:
    """Where a parameter tree lies: its first tensor's device (None for a
    tree without tensors)."""
    if isinstance(tree, torch.Tensor):
        return tree.device
    for v in (tree.values() if isinstance(tree, dict) else ()):
        dev = _device_of(v)
        if dev is not None:
            return dev
    return None


class ServeEngine:
    def __init__(self, model, params, max_seq: int,
                 batch_slots: int = 8, temperature: float = 0.0,
                 seed: int = 0,
                 metrics: Optional[MetricsRegistry] = None):
        self.model = model
        self.params = params
        self.max_seq = max_seq
        self.slots = batch_slots
        self.temperature = temperature
        self.device = _device_of(params) or torch.device("cpu")
        cfg = getattr(model, "cfg", None)
        self.frames_shape = ((cfg.n_frames, cfg.d_model)
                             if getattr(cfg, "enc_dec", False) else None)
        self.generator = torch.Generator(self.device).manual_seed(seed)
        self.decode_steps = 0       # decode iterations actually executed
        self.metrics = metrics if metrics is not None else MetricsRegistry()

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        if self.temperature <= 0:
            return torch.argmax(logits, -1).to(torch.int32)
        probs = torch.softmax(logits.to(torch.float32) / self.temperature,
                              -1)
        return torch.multinomial(probs, 1, generator=self.generator)[:, 0] \
            .to(torch.int32)

    def generate(self, requests: List[Request]) -> List[Request]:
        """Serve all requests, `slots` at a time (padded static batch).
        ``generate([])`` is a no-op; invalid requests raise before any
        prefill runs (no partial generation on bad input)."""
        for r in requests:
            if len(r.prompt) == 0:
                raise ValueError("empty prompt (nothing to prefill)")
            if len(r.prompt) > self.max_seq:
                raise ValueError(
                    f"prompt length {len(r.prompt)} exceeds max_seq="
                    f"{self.max_seq} (the KV cache would be written out "
                    "of range)")
            if r.max_new_tokens < 1:
                raise ValueError(
                    f"max_new_tokens={r.max_new_tokens} must be >= 1")
            self._check_frames(r)
        for lo in range(0, len(requests), self.slots):
            self._generate_batch(requests[lo:lo + self.slots])
        return requests

    def _check_frames(self, r: Request) -> None:
        if self.frames_shape is None:
            if r.frames is not None:
                raise ValueError("a decoder-only model takes no frames "
                                 "(Request.frames must be None)")
            return
        if r.frames is None:
            raise ValueError("an encoder-decoder model needs "
                             "Request.frames (its encoder's input)")
        if tuple(np.shape(r.frames)) != self.frames_shape:
            raise ValueError(
                f"Request.frames has shape {tuple(np.shape(r.frames))}, "
                f"the model takes {self.frames_shape}")

    def _record(self, reqs: Sequence[Request], tok: torch.Tensor,
                done: np.ndarray) -> None:
        """Record one sampled token per still-running request, applying
        the EOS check and max_new_tokens cutoff uniformly (the prefill
        token goes through this exact path too). One host read a step."""
        toks = tok.tolist()
        for i, r in enumerate(reqs):
            if done[i]:
                continue
            t = toks[i]
            if r.eos_id is not None and t == r.eos_id:
                done[i] = True
                r.done = True
                self.metrics.counter("serve_requests_completed").inc(
                    1, reason="eos")
                continue
            r.out.append(t)
            self.metrics.counter("serve_tokens_sampled").inc(1)
            if len(r.out) >= r.max_new_tokens:
                done[i] = True
                r.done = True
                self.metrics.counter("serve_requests_completed").inc(
                    1, reason="max_new_tokens")

    def _generate_batch(self, reqs: List[Request]) -> None:
        b = self.slots
        plen = max(len(r.prompt) for r in reqs)
        toks = np.zeros((b, plen), np.int32)
        for i, r in enumerate(reqs):
            toks[i, plen - len(r.prompt):] = r.prompt  # left-pad
        batch = {"tokens": torch.from_numpy(toks).to(self.device)}
        if self.frames_shape is not None:
            frames = np.zeros((b,) + self.frames_shape, np.float32)
            for i, r in enumerate(reqs):
                frames[i] = r.frames
            batch["frames"] = torch.from_numpy(frames).to(self.device)
        logits, caches = self.model.prefill(self.params, batch,
                                            skv=self.max_seq)
        self.metrics.counter("serve_prefill_batches").inc(1)
        self.metrics.counter("serve_prefill_tokens").inc(len(reqs) * plen)
        pos = torch.full((b,), plen, dtype=torch.int32, device=self.device)
        step_pos = plen                 # pos is uniform across slots
        tok = self._sample(logits)
        max_new = max(r.max_new_tokens for r in reqs)
        done = np.zeros(b, bool)
        done[len(reqs):] = True         # padded slots: nothing to serve
        self._record(reqs, tok, done)
        for _ in range(max_new - 1):
            if done.all() or step_pos >= self.max_seq - 1:
                break
            logits, caches = self.model.decode_step(
                self.params, caches, {"tokens": tok[:, None], "pos": pos})
            self.decode_steps += 1
            self.metrics.counter("serve_decode_steps").inc(1)
            tok = self._sample(logits)
            pos = pos + 1
            step_pos += 1
            self._record(reqs, tok, done)
        for r in reqs:
            if not r.done:      # decode loop exhausted max_seq first
                self.metrics.counter("serve_requests_completed").inc(
                    1, reason="truncated")
            r.done = True
