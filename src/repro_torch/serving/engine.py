"""Serving engine: slot-based continuous batching (port of
``repro.serving.engine.ServeEngine``, slot cache, full prefill).

The host loop is thin: per-request decisions live in
:mod:`repro_torch.serving.scheduler`, sampling runs on the device, and
only the sampled ``(slots,)`` token ids come back to the host each step.
Every step has a fixed shape: prefill runs all slots over
``prefill_len`` tokens, decode runs all slots over one token. Only the
slots a step planned for have their new cache rows written (in place,
through the step's ``CacheView.write_mask``). The JAX engine computes a
new cache and merges those slots back with ``merge_cache_slots``; that
gives the same cache, with copies of it.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from repro_torch.models.cache import CacheView
from repro_torch.models.common import check_quantize
from repro_torch.models.transformer import LM
from repro_torch.quant.calibrate import quantize_tree
from repro_torch.serving.sampling import make_sampler
from repro_torch.serving.scheduler import Request, Scheduler

__all__ = ["Request", "ServeEngine"]


class ServeEngine:
    """Slot-based continuous batching over fixed-shape steps.

    ``lm`` holds its weights on its device; the cache, the sampler's
    generator and every step run there.

    ``quantize="int8"`` quantizes every compressed ``Linear`` of ``lm``
    in place at construction (per-output-channel absmax scales; the
    counterpart of the JAX engine's ``quantize_tree`` on its params);
    dense weights are untouched, and every compressed GEMM then runs
    through the int8 families. The scales come from the values the model
    holds: on an f32 model the result is bit-equal to the JAX engine's,
    on a bf16 model they come from the bf16 values (to build an int8
    model from f32 values, pass ``quantize`` to ``LM.init`` instead).
    """

    def __init__(self, lm: LM, *, slots: int, max_seq: int,
                 prefill_len: int, temperature: float = 0.0, seed: int = 0,
                 strict: bool = False, quantize: Optional[str] = None):
        check_quantize(quantize)
        if quantize == "int8":
            quantize_tree(lm)
        self.lm = lm
        self.device = lm.device
        self.slots = slots
        self.max_seq = max_seq
        self.prefill_len = prefill_len
        self.temperature = temperature
        self.scheduler = Scheduler(slots=slots, max_seq=max_seq,
                                   prefill_len=prefill_len, strict=strict)
        self._sampler = make_sampler(temperature)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        self.caches = lm.init_cache(slots, max_seq)
        self.decode_times: list[float] = []

    # ---- device steps -----------------------------------------------------

    @torch.inference_mode()
    def _run(self, tokens: np.ndarray, view: CacheView) -> np.ndarray:
        logits, _ = self.lm(torch.as_tensor(tokens, device=self.device),
                            view=view, caches=self.caches)
        toks = self._sampler(logits[:, -1], self._gen)
        return toks.cpu().numpy()  # the step's one device sync

    # ---- public API -------------------------------------------------------

    def submit(self, req: Request) -> None:
        self.scheduler.submit(req, now=time.perf_counter())

    def step(self) -> None:
        """One engine step: a batched prefill for every newly admitted
        slot, then one decode for every slot whose prefill completed."""
        sched = self.scheduler
        pf = sched.plan_prefill()
        if pf is not None:
            toks = self._run(pf.tokens, CacheView.prefill(pf.mask))
            sched.finish_prefill(pf, toks, now=time.perf_counter())
        dc = sched.plan_decode()
        if dc is not None:
            toks = self._run(dc.tokens,
                             CacheView.decode(dc.lengths, dc.mask))
            now = time.perf_counter()
            self.decode_times.append(now)
            if len(self.decode_times) > 8192:  # bounded history
                del self.decode_times[:4096]
            sched.finish_decode(dc, toks, now=now)

    def run(self, max_steps: int = 10_000) -> list[Request]:
        steps = 0
        while self.scheduler.has_work and steps < max_steps:
            self.step()
            steps += 1
        return self.scheduler.finished

    def throughput_stats(self) -> dict:
        """Serving metrics over every finished request: generated tokens,
        mean and p50/p99 time to first token, and p50/p99 inter-token
        latency pooled from each request's own token timestamps."""
        reqs = list(self.scheduler.finished)
        toks = sum(len(r.out) for r in reqs)
        ttfts = [r.t_first - r.t_submit for r in reqs
                 if r.t_first is not None and r.t_submit is not None]
        gaps = [r.itl_s() for r in reqs]
        itl = np.concatenate(gaps) if gaps else np.asarray([])

        def pct(a, q):
            return float(np.percentile(a, q)) if len(a) else float("nan")

        return {
            "requests": len(reqs),
            "tokens": toks,
            "decode_steps": len(self.decode_times),
            "ttft_s": float(np.mean(ttfts)) if ttfts else float("nan"),
            "ttft_p50_s": pct(ttfts, 50),
            "ttft_p99_s": pct(ttfts, 99),
            "itl_p50_s": pct(itl, 50),
            "itl_p99_s": pct(itl, 99),
        }
