"""The port's per-device op count (``analysis/opcount.py``, the stand-in
for ``analysis/hlo.py``) and its breakdown rows.

The counterparts of ``tests/test_hlo_analysis.py`` and of the
breakdown cases of ``tests/test_analysis_roofline.py``: one product's
FLOPs exactly, a batched one, a loop of 12 products charged x12 with the
x12 in the rows, rows that sum to the totals, the ring model equal to the
reference's ``_collective_traffic``, and ``roofline_terms`` on the result.
The per-device case runs a column- then row-parallel MLP on a fake 1 x 4
mesh, in a process of its own (a fake group is its process's default
group): each rank counts a quarter of the global FLOPs, while a counter
opened outside DTensor's dispatch (``FlopCounterMode``) sees the global
program.
"""
import json
import os
import subprocess
import sys

import pytest
import torch

from repro.analysis.hlo import _collective_traffic as jx_traffic
from repro_torch.analysis import H100, OpCounter, analyze, roofline_terms
from repro_torch.analysis.breakdown import instruction_rows
from repro_torch.analysis.opcount import ModuleCost, _collective_traffic

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_single_product_flops_exact():
    a, b = torch.randn(32, 48), torch.randn(48, 16)
    _, cost, _ = analyze(lambda: a @ b)
    assert cost.flops == 2 * 32 * 48 * 16
    assert cost.dot_count == 1


def test_batched_product_flops():
    a, b = torch.randn(4, 8, 16), torch.randn(4, 16, 8)
    _, cost, _ = analyze(lambda: torch.einsum("bij,bjk->bik", a, b))
    assert cost.flops == 2 * 4 * 8 * 16 * 8


def test_addmm_and_meta_tensors_count_as_products():
    bias, a, b = (torch.randn(16, device="meta"),
                  torch.randn(32, 48, device="meta"),
                  torch.randn(48, 16, device="meta"))
    _, cost, _ = analyze(torch.nn.functional.linear, a, b.T, bias)
    assert cost.flops == 2 * 32 * 48 * 16


def test_loop_of_twelve_products_is_charged_twelve_times():
    x, w = torch.randn(64, 64), torch.randn(12, 64, 64)

    def f():
        c = x
        for i in range(12):
            c = torch.tanh(c @ w[i])
        return c

    _, cost, counter = analyze(f)
    assert cost.flops == 2 * 64 ** 3 * 12
    rows = [r for r in instruction_rows(counter) if r[1]]
    assert len(rows) == 1
    b, f_, mult, op, desc = rows[0]
    assert (mult, op, f_) == (12, "mm", 2 * 64 ** 3 * 12)
    assert "float32[64,64]" in desc
    assert cost.while_trips == []


def test_rows_sum_to_the_totals_and_bytes_follow_operands():
    x, w = torch.randn(8, 16), torch.randn(16, 4)

    def f():
        h = torch.relu(x @ w)            # mm + relu
        return h.t().contiguous().sum()  # t is a view: not charged

    _, cost, counter = analyze(f)
    rows = instruction_rows(counter)
    assert sum(r[0] for r in rows) == cost.hbm_bytes
    assert sum(r[1] for r in rows) == cost.flops
    mm = [r for r in rows if r[3] == "mm"][0]
    assert mm[0] == 4 * (8 * 16 + 16 * 4 + 8 * 4)       # operands + result
    assert not any(r[3] in ("t", "transpose", "view") for r in rows)


def test_memory_peak_follows_live_storage():
    with OpCounter() as c:
        a = torch.empty(1024, dtype=torch.float32) + 1     # 4 KiB live
        b = a * 2                                          # 8 KiB live
        del a
        d = b + 1                                          # 8 KiB again
        del b, d
    assert c.peak_bytes == 8192
    assert c.live_bytes == 0


@pytest.mark.parametrize("op", ["all-reduce", "all-gather", "reduce-scatter",
                                "all-to-all", "collective-permute"])
@pytest.mark.parametrize("n", [1, 2, 4, 16, 256])
def test_collective_traffic_matches_reference(op, n):
    for rb in (0, 1024, 3 * 2 ** 20 + 7):
        assert _collective_traffic(op, rb, n) == jx_traffic(op, rb, n)


def test_roofline_terms_on_the_count():
    a, b = torch.randn(256, 256, dtype=torch.bfloat16), \
        torch.randn(256, 256, dtype=torch.bfloat16)
    _, cost, _ = analyze(lambda: a @ b)
    assert cost.precision == "bf16"
    t = roofline_terms(cost, model_flops=cost.flops / 2)
    assert t.compute_s == cost.flops / H100.bf16_flops
    assert t.memory_s == cost.hbm_bytes / H100.hbm_bw
    assert t.collective_s == 0.0
    assert t.useful_ratio == 0.5
    c = ModuleCost(flops=67e12, hbm_bytes=3.35e12, collective_bytes=450e9)
    t = roofline_terms(c)
    assert abs(t.compute_s - 1.0) < 1e-12 and abs(t.memory_s - 1.0) < 1e-12
    assert abs(t.collective_s - 1.0) < 1e-12


_FAKE_MESH_SCRIPT = r"""
import json, sys
import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils.flop_counter import FlopCounterMode
from repro_torch.analysis import OpCounter

dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
mesh = init_device_mesh("cpu", (1, 4), mesh_dim_names=("data", "model"))


def dt(shape, pl):
    return DTensor.from_local(torch.empty(shape, device="meta",
                                          dtype=torch.bfloat16),
                              mesh, pl, run_check=False)


# [64, 512, 2048] -> 8192 -> 2048: wi column-parallel, wo row-parallel
x = dt((64, 512, 2048), [Replicate(), Replicate()])
wi = dt((2048, 8192 // 4), [Replicate(), Shard(1)])
wo = dt((8192 // 4, 2048), [Replicate(), Shard(0)])
mlp = lambda: (torch.relu(x @ wi) @ wo).redistribute(
    mesh, [Replicate(), Replicate()])
with OpCounter() as c:
    mlp()
with FlopCounterMode(display=False) as g:
    mlp()
cost = c.cost()
print(json.dumps({"local": cost.flops, "outside": g.get_total_flops(),
                  "counts": dict(cost.collective_counts),
                  "coll": cost.collective_bytes}))
"""


def test_fake_mesh_counts_per_device_not_global():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", _FAKE_MESH_SCRIPT],
                       capture_output=True, text=True, env=env, cwd=ROOT,
                       timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])
    glob = 2 * 64 * 512 * 2048 * 8192 * 2      # both products, whole mesh
    assert got["local"] == glob / 4
    assert got["outside"] == glob               # the trap: global, not local
    # the row-parallel product's partial sums: one all-reduce of the
    # [64, 512, 2048] bf16 result over the 4 ranks of 'model'
    assert got["counts"] == {"all-reduce": 1.0}
    assert got["coll"] == 2.0 * 64 * 512 * 2048 * 2 * 3 / 4
