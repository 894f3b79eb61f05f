"""The comparison that decides a run's ``correct``.

Both sides give the readings of ``reference.train.follow``: the loss
and the gradients' global norm before clipping at each of the first
steps, each leaf's gradient at step 1 as the optimizer gets it, before
clipping (the program's worked out from its first moment after one step:
m / (1 - b1), over the clipping scale of its own reported norm), and
each leaf's change over the first steps. A leaf is one layer's slice of
a stacked parameter, or a whole unstacked one. The numbers:

  loss, loss1     the largest relative gap of a step's loss; of step 1's;
  gnorm, gnorm1   the same of the gradients' global norm;
  grad_leaf       the worst leaf's gap between the two gradient norms,
                  over the reference's norm of that leaf or of the
                  median leaf, whichever is larger;
  grad_median     the median leaf's such gap;
  delta_leaf      the worst leaf's gap of the change, leaving out leaves
  delta_median    whose reference gradient is under a thousandth of the
                  median leaf's (they move by round-off alone); the
                  median leaf's.

``limits/<workload>.json`` names the numbers a cell is held to and the
limit of each; the others are printed to standard error, not judged.
"""
from __future__ import annotations

import math
import statistics

NAMES = ("loss", "loss1", "gnorm", "gnorm1", "grad_leaf", "grad_median",
         "delta_leaf", "delta_median")
NEGLIGIBLE = 1e-3


def _rel(got: list, ref: list) -> float:
    if len(got) != len(ref):
        return math.inf
    gaps = [abs(a - b) / abs(b) for a, b in zip(got, ref)]
    return max(gaps) if all(math.isfinite(g) for g in gaps) else math.inf


def leaf_gaps(got: dict, ref: dict, keep=None) -> dict:
    """{leaf: the gap of its norms over max(the leaf's, the median
    leaf's reference norm)}; a leaf missing or not finite reads inf."""
    names = [k for k in ref if keep is None or k in keep]
    med = statistics.median(ref[k] for k in names)
    out = {}
    for k in names:
        a = got.get(k, math.inf)
        gap = abs(a - ref[k]) / max(ref[k], med)
        out[k] = gap if math.isfinite(gap) else math.inf
    return out


def _worst(gaps: dict) -> tuple:
    at = max(gaps, key=gaps.get)
    return gaps[at], at


def numbers(got: dict, ref: dict) -> tuple:
    """({name: value} of every number in ``NAMES``, {name: the leaf the
    worst-leaf numbers come from})."""
    med = statistics.median(ref["grad"].values())
    keep = {k for k, g in ref["grad"].items() if g >= NEGLIGIBLE * med}
    grad = leaf_gaps(got["grad"], ref["grad"])
    delta = leaf_gaps(got["delta"], ref["delta"], keep)
    (g, g_at), (d, d_at) = _worst(grad), _worst(delta)
    return ({"loss": _rel(got["loss"], ref["loss"]),
             "loss1": _rel(got["loss"][:1], ref["loss"][:1]),
             "gnorm": _rel(got["gnorm"], ref["gnorm"]),
             "gnorm1": _rel(got["gnorm"][:1], ref["gnorm"][:1]),
             "grad_leaf": g,
             "grad_median": statistics.median(grad.values()),
             "delta_leaf": d,
             "delta_median": statistics.median(delta.values())},
            {"grad_leaf": g_at, "delta_leaf": d_at})


def top_gaps(got: dict, ref: dict, key: str, n: int = 5) -> list:
    """The ``n`` leaves of ``key`` whose norms differ most, relative to
    the reference's: [(leaf, program, reference)]."""
    g, r = got[key], ref[key]
    gap = lambda k: abs(g.get(k, math.inf) - r[k]) / max(r[k], 1e-30)
    return [(k, g.get(k), r[k]) for k in sorted(r, key=gap)[-n:]]


def judge(values: dict, limits: dict) -> bool:
    """Every number the cell's limits name within its limit (a NaN is
    not)."""
    return all(values[k] <= v for k, v in limits.items())
