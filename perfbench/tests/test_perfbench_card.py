"""On the card, at each cell's own size: the control (the reference
computed with float8 operands in the program's place) fails the cell's
limits on three seeds. Run there with
``python -m pytest -m card perfbench/tests``; skips without a card."""
import json
from pathlib import Path

import pytest

from perfbench import compare, harness

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_at_the_cells_size_comes_out_incorrect(card, cell):
    c = harness.Cell.load(cell)
    for seed in (2 ** 31 + 11, 12, 13):
        batches = c.batches(seed, card)
        ref = c.reference(seed, card, batches)
        ctl = c.reference(seed, card, batches, "fp8")
        values, _ = compare.numbers(ctl, ref)
        assert not compare.judge(values, c.limits), values
