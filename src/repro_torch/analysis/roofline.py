"""Roofline terms of one kernel launch or step on an NVIDIA H100.

The counterpart of ``repro.analysis.roofline``: ``HW``, ``RooflineTerms``,
``roofline_terms`` and the LM stack's ``model_flops``. All three terms are
seconds on one card:

  compute_s    = operations / the card's peak rate for their type
  memory_s     = device-memory bytes / the memory rate
  collective_s = bytes across cards / (links * link rate)

The dominant term lower-bounds the launch; ``bound_s`` is the largest.
``H100`` is NVIDIA's H100 SXM data sheet (dense rates, no sparsity) at
its full 700 W power limit: 3.35 TB/s HBM3, 80 GB, 232,448 bytes of
shared memory a block, NVLink 450 GB/s each way, 67 TFLOP/s f32 on the
CUDA cores, 495 TFLOP/s TF32, 989.4 TFLOP/s bf16 and 1,979 TOP/s int8 on
the tensor cores.
"""
from __future__ import annotations

import dataclasses

from ..models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class HW:
    peak_flops: float = 67e12       # f32 on the CUDA cores, flop/s
    tf32_flops: float = 495e12      # TF32 tensor cores, dense
    bf16_flops: float = 989.4e12    # bf16 tensor cores, dense
    int8_ops: float = 1979e12       # int8 tensor cores, dense
    hbm_bw: float = 3.35e12         # bytes/s
    link_bw: float = 450e9          # NVLink, bytes/s each way
    n_links: int = 1                # the aggregate NVLink rate above
    smem_bytes: int = 232_448       # shared memory a block may opt into
    sm_smem_bytes: int = 233_472    # shared memory of one SM
    n_sms: int = 132
    hbm_bytes: int = 80 * 10 ** 9

    def peak(self, precision: str) -> float:
        """Peak rate for operations of ``precision``: ``f32`` (CUDA
        cores), ``tf32``, ``bf16`` or ``int8`` (tensor cores)."""
        return {"f32": self.peak_flops, "tf32": self.tf32_flops,
                "bf16": self.bf16_flops, "int8": self.int8_ops}[precision]


H100 = HW()


@dataclasses.dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    flops: float
    hbm_bytes: float
    collective_bytes: float
    model_flops: float = 0.0

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_ratio(self) -> float:
        """MODEL_FLOPS / counted FLOPs (remat / redundancy waste
        detector)."""
        return self.model_flops / self.flops if self.flops else 0.0

    def as_dict(self) -> dict:
        return {"compute_s": self.compute_s, "memory_s": self.memory_s,
                "collective_s": self.collective_s, "dominant": self.dominant,
                "flops": self.flops, "hbm_bytes": self.hbm_bytes,
                "collective_bytes": self.collective_bytes,
                "model_flops": self.model_flops,
                "useful_ratio": self.useful_ratio}


def roofline_terms(cost, hw: HW = H100, model_flops: float = 0.0
                   ) -> RooflineTerms:
    """cost: anything with ``flops``, ``hbm_bytes`` and
    ``collective_bytes`` (a ``tuning.prune.LaunchCost``); its
    ``precision`` (default ``f32``) picks the peak the operations run
    at."""
    peak = hw.peak(getattr(cost, "precision", "f32"))
    return RooflineTerms(
        compute_s=cost.flops / peak,
        memory_s=cost.hbm_bytes / hw.hbm_bw,
        collective_s=cost.collective_bytes / (hw.n_links * hw.link_bw),
        flops=cost.flops,
        hbm_bytes=cost.hbm_bytes,
        collective_bytes=cost.collective_bytes,
        model_flops=model_flops,
    )


def model_flops(cfg: ModelConfig, n_tokens: int, kind: str) -> float:
    """MODEL_FLOPS = 6*N*D (train) or 2*N*D (fwd-only) with N = active
    params (MoE top-k counts only routed-active experts)."""
    n = cfg.active_param_count()
    mult = 6.0 if kind == "train" else 2.0
    return mult * n * n_tokens
