"""Batched serving driver: length-bucketed cohort batching.

The counterpart of ``repro.launch.serve``. Requests are bucketed by prompt
length; a cohort of up to ``slots`` equal-length prompts shares one decode
step (one cache pool, one position counter). Prefill is teacher-forced
batched decode over the prompt; finished sequences idle (their sampled
tokens are discarded) until the cohort retires. Greedy decoding. The
steps run eagerly on the card.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-1.8b \
      --slots 4 --max-new 16 --requests 8 [--full] [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from collections import defaultdict

import numpy as np
import torch

from .._device import resolve_device
from ..configs import get_config
from ..models import build
from .steps import make_serve_step


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list
    max_new: int
    out: list = dataclasses.field(default_factory=list)
    done: bool = False


class Server:
    """Length-bucketed static batching over ``slots`` concurrent slots."""

    def __init__(self, arch: str, *, smoke: bool = True, slots: int = 4,
                 capacity: int = 128, seed: int = 0, device="cuda"):
        self.device = resolve_device(device)
        self.cfg = get_config(arch, smoke=smoke)
        if self.cfg.is_encdec:
            raise ValueError("the serve driver targets decoder LMs")
        self.model = build(self.cfg)
        self.params = self.model.init(seed, device=self.device)
        self.slots = slots
        self.capacity = capacity
        self.buckets: dict = defaultdict(list)      # prompt len -> requests
        self._step = make_serve_step(self.model)
        self.steps_run = 0

    def submit(self, req: Request):
        self.buckets[len(req.prompt)].append(req)

    # ------------------------------------------------------------ cohorts
    def _next_cohort(self) -> list:
        for ln in sorted(self.buckets, key=lambda l: -len(self.buckets[l])):
            if self.buckets[ln]:
                reqs = self.buckets[ln][:self.slots]
                self.buckets[ln] = self.buckets[ln][len(reqs):]
                return reqs
        return []

    def _run_cohort(self, reqs: list):
        b = self.slots
        plen = len(reqs[0].prompt)
        max_new = max(r.max_new for r in reqs)
        if plen + max_new > self.capacity:
            raise ValueError(f"capacity {self.capacity} too small for "
                             f"{plen} + {max_new} tokens")
        caches = self.model.init_caches(b, self.capacity,
                                        device=self.device)
        prompts = np.zeros((b, plen), np.int32)
        for i, r in enumerate(reqs):
            prompts[i] = r.prompt
        prompts = torch.from_numpy(prompts).to(self.device)
        # teacher-forced batched prefill (shared position counter)
        logits = None
        for p in range(plen):
            logits, caches = self._step(self.params, caches,
                                        prompts[:, p:p + 1], p)
            self.steps_run += 1
        # batched decode; finished slots idle until cohort retires
        tok = torch.argmax(logits, dim=-1)
        for n in range(max_new):
            got = tok[:, 0].tolist()
            for i, r in enumerate(reqs):
                if len(r.out) < r.max_new:
                    r.out.append(got[i])
                    r.done = len(r.out) >= r.max_new
            if all(r.done for r in reqs):
                break
            logits, caches = self._step(self.params, caches, tok, plen + n)
            self.steps_run += 1
            tok = torch.argmax(logits, dim=-1)

    def run(self) -> int:
        """Serve everything queued. Returns total generated tokens."""
        total = 0
        while True:
            cohort = self._next_cohort()
            if not cohort:
                break
            self._run_cohort(cohort)
            total += sum(len(r.out) for r in cohort)
        return total


def requests(vocab: int, n: int, max_new: int, seed: int = 0) -> list:
    """The CLI's request mix: ``n`` prompts of 3 or 5 random tokens (3
    twice as often), ``max_new`` new tokens each."""
    rng = np.random.default_rng(seed)
    return [Request(i, rng.integers(0, vocab, int(rng.choice([3, 3, 5])))
                    .tolist(), max_new) for i in range(n)]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--full", action="store_true",
                    help="full config (default: smoke-reduced)")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--capacity", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    srv = Server(args.arch, smoke=not args.full, slots=args.slots,
                 capacity=args.capacity, device=args.device)
    reqs = requests(srv.cfg.vocab, args.requests, args.max_new)
    for r in reqs:
        srv.submit(r)
    t0 = time.time()
    total = srv.run()
    dt = time.time() - t0
    print(f"served {len(reqs)} requests, {total} tokens in {dt:.2f}s "
          f"({total / dt:.1f} tok/s, {srv.steps_run} batched steps)")
    for r in reqs[:3]:
        print(f"  req {r.rid}: prompt {r.prompt} -> {r.out[:8]}...")


if __name__ == "__main__":
    main()
