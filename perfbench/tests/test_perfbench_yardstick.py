"""The yardstick against values worked out by hand from the published
shapes."""
import json
from pathlib import Path

import pytest

from perfbench import yardstick as y
from perfbench.reference import internlm2

ROOT = Path(__file__).resolve().parents[2]


def config(name: str) -> dict:
    return json.loads((ROOT / "perfbench" / "configs"
                       / f"{name}.json").read_text())


def specs() -> dict:
    return internlm2.param_specs(config("internlm2-1.8b")["model"])


# internlm2-1.8b: embedding and head 2 x 92,544 x 2,048; a layer wq and
# wo 2,048^2 each, wk and wv 2,048 x 1,024 each, SwiGLU 2,048 x 16,384 +
# 8,192 x 2,048, two norms of 2,048; the final norm 2,048
INTERNLM2_N = 2 * 92544 * 2048 + 24 * (
    2 * 2048 * 2048 + 2 * 2048 * 1024 + 2048 * 16384 + 8192 * 2048
    + 2 * 2048) + 2048
# float32 parameters: the norms
INTERNLM2_F32 = 2048 + 24 * 2 * 2048


def test_parameters_and_adamw_bytes():
    s = specs()
    assert y.param_count(s) == INTERNLM2_N
    assert config("internlm2-1.8b")["parameters"] == INTERNLM2_N
    # 22 B a bf16 parameter (2 + 2 read and written, 2 of gradient, 16 of
    # the two float32 moments), 28 B a float32 one
    assert y.adamw_bytes(s) == 22 * (INTERNLM2_N - INTERNLM2_F32) \
        + 28 * INTERNLM2_F32


# 6 N D: 23.213 TFLOP a step at 4 x 512 tokens, 46.427 at 1 x 4,096
@pytest.mark.parametrize("traffic,tflop", [("train-4x512", 23.213),
                                           ("train-1x4096", 46.427)])
def test_step_flops_of_each_traffic(traffic, tflop):
    t = json.loads((ROOT / "perfbench" / "traffic"
                    / f"{traffic}.json").read_text())
    d = t["batch"] * t["seq"]
    assert y.train_flops(specs(), d) == 6 * INTERNLM2_N * d
    assert y.train_flops(specs(), d) == pytest.approx(tflop * 1e12,
                                                      rel=1e-4)


def test_published_counts():
    assert INTERNLM2_N == 1_889_110_016


def test_adamw_bound_internlm2():
    s = specs()
    assert y.adamw_bytes(s) == 41_561_022_464
    assert y.adamw_bytes(s) / y.H100["hbm_bps"] * 1e3 == pytest.approx(
        12.406, abs=1e-3)
