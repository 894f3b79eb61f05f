"""Roofline analysis of the port's kernels on the card (``roofline``)."""
