"""Continuous-batching inference engine with step-boundary preemption.

Lanes hold per-sequence KV caches or recurrent states inside one batched
cache tree; ``decode_tick`` advances every lane with one batched decode
step (ragged lengths through the cache's per-lane ``len``). LCFSP
preemption frees a lane between steps; the scheduler decides when.

A "frame analysis" request is a prefill of the frame's tokens plus
``decode_tokens`` decode steps. An admit is one function, as the JAX
package's fused admit: prefill into a memoised single-lane cache, copy
that cache into the lane, take the first token's argmax. The JAX package
never writes its single-lane cache, so each of its prefills starts from
zeros; here the prefill writes the cache in place, so it is zeroed before
each prefill. Without that an sLSTM layer, whose prefill starts from the
cache's state, would start from the previous prompt's state.

The caches are updated in place (the JAX package makes new ones), so an
admit or a tick allocates no cache. The engine runs on ``device``, CUDA
by default; its model then runs through the CUDA kernels.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device
from ..models import common as c
from ..models.common import init_params, tree_leaves, tree_map
from .scheduler import Frame

FREE, DECODING = 0, 2


@dataclasses.dataclass
class LaneState:
    status: int = FREE
    stream_id: int = -1
    frame: Optional[Frame] = None
    remaining: int = 0
    out: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Result:
    stream_id: int
    frame: Frame
    tokens: np.ndarray
    t_done: float = 0.0


def _insert_lane(batched, single, lane: int):
    """Copy a 1-lane cache into lane ``lane`` of the batched cache, in
    place. Block-stack leaves carry a leading n_periods dim
    (``[P, lanes, ...]`` against ``[P, 1, ...]``); the top-level ``len``
    leaf is ``[lanes]``. Dispatch on rank, as the JAX package does."""
    def ins(b, s):
        if b.dim() == s.dim() and b.shape[0] == s.shape[0] and b.dim() >= 2:
            b[:, lane] = s[:, 0]                   # [P, lanes, ...]
        else:
            b[lane] = s[0]                         # [lanes, ...]
        return b
    return tree_map(ins, batched, single)


class Engine:
    def __init__(self, model, params, n_lanes: int = 8, max_len: int = 256,
                 decode_tokens: int = 8, device=DEFAULT_DEVICE):
        self.device = resolve_device(device)
        self.model = model
        self.params = params
        self.n_lanes = n_lanes
        self.max_len = max_len
        self.decode_tokens = decode_tokens
        zeros = torch.Generator(device=self.device)   # the caches draw none
        self.cache = init_params(model.cache_template(n_lanes, max_len),
                                 zeros, device=self.device)
        self._single_cache = init_params(model.cache_template(1, max_len),
                                         zeros, device=self.device)
        self.lanes: List[LaneState] = [LaneState() for _ in range(n_lanes)]
        self._steps = 0

    # ------------------------------------------------------------------
    def free_lanes(self) -> List[int]:
        return [i for i, l in enumerate(self.lanes) if l.status == FREE]

    def preempt_stream(self, stream_id: int) -> int:
        """Abort any in-flight lane of this stream (LCFSP). Returns count."""
        n = 0
        for lane in self.lanes:
            if lane.status != FREE and lane.stream_id == stream_id:
                self._release(lane)
                n += 1
        return n

    def _release(self, lane: LaneState) -> None:
        """Return a lane to the free pool with no stale bookkeeping."""
        lane.status = FREE
        lane.stream_id = -1
        lane.frame = None
        lane.remaining = 0
        lane.out = []

    @torch.no_grad()
    def prefill_lane(self, tokens, lane: int) -> torch.Tensor:
        """Prefill ``tokens`` [seq] into lane ``lane`` (whatever its status)
        and return the last position's logits ``[V]``."""
        tok = torch.as_tensor(np.asarray(tokens, np.int32),
                              device=self.device)[None]
        for leaf in tree_leaves(self._single_cache):
            leaf.zero_()
        logits, single = self.model.prefill(self.params, {"tokens": tok},
                                            self._single_cache)
        self.cache = _insert_lane(self.cache, single, lane)
        return logits[0, -1]

    @torch.no_grad()
    def decode_logits(self, last: np.ndarray) -> torch.Tensor:
        """One batched decode step of every lane on the tokens ``last``
        [n_lanes]; returns the logits ``[n_lanes, V]``."""
        tok = torch.as_tensor(np.asarray(last, np.int32), device=self.device)
        logits, self.cache = self.model.decode_step(self.params, tok,
                                                    self.cache)
        return logits

    def admit(self, frame: Frame, tokens: np.ndarray,
              lane: Optional[int] = None) -> bool:
        """Prefill a frame into a free lane. tokens: int32 [seq].

        ``lane`` pins the request to a specific free lane (the engine
        replay plane keeps one lane per stream); default picks the first
        free lane. Returns False when no (or the pinned) lane is free."""
        if lane is None:
            free = self.free_lanes()
            if not free:
                return False
            lane = free[0]
        elif self.lanes[lane].status != FREE:
            return False
        first = int(torch.argmax(self.prefill_lane(tokens, lane)))
        st = self.lanes[lane]
        st.status = DECODING
        st.stream_id = frame.stream_id
        st.frame = frame
        st.remaining = self.decode_tokens
        st.out = [first]
        return True

    def decode_tick(self) -> List[Result]:
        """One batched decode step across all lanes; returns completions."""
        active = [i for i, l in enumerate(self.lanes) if l.status ==
                  DECODING]
        if not active:
            return []
        last = np.zeros((self.n_lanes,), np.int32)
        for i in active:
            last[i] = self.lanes[i].out[-1]
        nxt = torch.argmax(self.decode_logits(last), dim=-1).cpu().numpy()
        self._steps += 1
        done = []
        for i in active:
            lane = self.lanes[i]
            lane.out.append(int(nxt[i]))
            lane.remaining -= 1
            if lane.remaining <= 0:
                done.append(Result(lane.stream_id, lane.frame,
                                   np.asarray(lane.out)))
                self._release(lane)
        return done

    @property
    def utilization(self) -> float:
        busy = sum(1 for l in self.lanes if l.status != FREE)
        return busy / self.n_lanes


# ---------------------------------------------------------------------------
# Replay stub model
# ---------------------------------------------------------------------------

class NullAnalyticsModel:
    """Tiny deterministic recognition head for engine-rung replay.

    The engine rung needs the lane mechanics of a real continuous-batching
    engine (admit / prefill / decode_tick / preempt) at suite scale, where
    timing comes from sampled service draws, not model FLOPs. This stub
    has the model surface (``template`` / ``cache_template`` / ``prefill``
    / ``decode_step``) with a cumsum-embed recurrent cell.
    """

    def __init__(self, d: int = 8, vocab: int = 32):
        self.d = d
        self.vocab = vocab

    def template(self):
        return {"emb": c.P((self.vocab, self.d), (c.VOCAB, c.EMBED),
                           init="embed"),
                "out": c.P((self.d, self.vocab), (c.EMBED, c.VOCAB))}

    def cache_template(self, lanes: int, max_len: int):
        # The leading extent-1 dim of "state" takes _insert_lane's stacked
        # ([P, lanes, ...]) path; "len" takes the flat [lanes] path.
        return {"len": c.P((lanes,), (None,), init="zeros",
                           dtype=torch.int32),
                "state": c.P((1, lanes, self.d), (None, None, c.EMBED),
                             init="zeros")}

    def prefill(self, params, batch, cache):
        tok = batch["tokens"].long()                 # [B, S]
        emb = params["emb"][tok]                     # [B, S, d]
        states = torch.tanh(torch.cumsum(emb, dim=1))
        logits = states @ params["out"]              # [B, S, V]
        cache = {"len": torch.full_like(cache["len"], tok.shape[1]),
                 "state": states[:, -1:].transpose(0, 1)}
        return logits, cache

    def decode_step(self, params, tokens, cache):
        emb = params["emb"][tokens.long()]           # [lanes, d]
        state = torch.tanh(cache["state"][0] + emb)
        logits = state @ params["out"]               # [lanes, V]
        return logits, {"len": cache["len"] + 1, "state": state[None]}


def make_replay_engine(n_lanes: int, *, max_len: int = 64,
                       decode_tokens: int = 4, seed: int = 0,
                       device=DEFAULT_DEVICE) -> Engine:
    """Engine over :class:`NullAnalyticsModel` for the replay plane,
    deterministic under ``seed``, one lane per replayed stream."""
    dev = resolve_device(device)
    model = NullAnalyticsModel()
    params = init_params(model.template(),
                         torch.Generator(device=dev).manual_seed(seed),
                         device=dev)
    return Engine(model, params, n_lanes=n_lanes, max_len=max_len,
                  decode_tokens=decode_tokens, device=dev)
