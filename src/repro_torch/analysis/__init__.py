"""Roofline analysis on the card (``roofline``): the port's kernels and
the LM stack's model FLOPs; the per-device count of a step
(``opcount``, the stand-in for the reference's HLO analysis) and its
per-op breakdown (``breakdown``)."""
from .opcount import ModuleCost, OpCounter, analyze
from .roofline import H100, HW, RooflineTerms, model_flops, roofline_terms

__all__ = ["H100", "HW", "ModuleCost", "OpCounter", "RooflineTerms",
           "analyze", "model_flops", "roofline_terms"]
