"""Faults planted inside the RWKV time mix, beside ``readings.py``'s.

  python3 perfbench/tools/timemix_faults.py --workload <name> \
      [every argument of readings.py]

Runs ``readings.py`` with its faults and three more, each a step hook as
theirs are (the step runs with the fault in place, the state it returns
is read as it is):

  scan_dw_dropped   w enters ``wkv6_scan`` with a zero gradient: the
                    decays and the decay LoRA get no gradient through the
                    scan, the forward unchanged;
  bonus_dropped     the scan runs with u = 0 (no bonus for the current
                    token);
  one_leaf_unmoved  the update of layer 0's receptance matrix
                    (``mixer.wr``) dropped.
"""
from __future__ import annotations

import contextlib
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent.parent


@contextlib.contextmanager
def _scan_through(change):
    """``models.recurrent``'s scan calls with their arguments passed
    through ``change(r, k, v, w, u)`` first."""
    from repro_torch.models import recurrent
    scan = recurrent._wkv6_scan_local

    def broken(r, k, v, w, u, s0):
        return scan(*change(r, k, v, w, u), s0)

    recurrent._wkv6_scan_local = broken
    try:
        yield
    finally:
        recurrent._wkv6_scan_local = scan


def _during(change):
    def hook(step):
        def broken(p, o, b):
            with _scan_through(change):
                return step(p, o, b)
        return broken
    return hook


def one_leaf_unmoved(step):
    """The update of layer 0's ``mixer.wr`` dropped."""
    def broken(p, o, b):
        new_p, new_o, met = step(p, o, b)
        mixer = new_p["main"]["sub0"]["mixer"]
        w = mixer["wr"].clone()
        w[0] = p["main"]["sub0"]["mixer"]["wr"][0]
        mixer["wr"] = w
        return new_p, new_o, met
    return broken


FAULTS = {
    "scan_dw_dropped": _during(
        lambda r, k, v, w, u: (r, k, v, w.detach() + 0 * w, u)),
    "bonus_dropped": _during(lambda r, k, v, w, u: (r, k, v, w, 0 * u)),
    "one_leaf_unmoved": one_leaf_unmoved,
}


def main(argv=None) -> int:
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from perfbench.tools import readings
    readings.FAULTS.update(FAULTS)
    return readings.main(argv)


if __name__ == "__main__":
    sys.exit(main())
