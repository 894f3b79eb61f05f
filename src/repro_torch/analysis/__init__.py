"""Roofline analysis on the card (``roofline``): the port's kernels and
the LM stack's model FLOPs."""
from .roofline import H100, HW, RooflineTerms, model_flops, roofline_terms

__all__ = ["H100", "HW", "RooflineTerms", "model_flops", "roofline_terms"]
