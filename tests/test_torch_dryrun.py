"""The port's dry run against the reference's, on smoke internlm2 cells.

The reference lowers and compiles each cell (``repro.launch.dryrun.
lower_cell``) on 8 host devices in a subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=8``, as
``tests/test_torch_spmd.py`` runs it; the port runs one step of each cell
on meta shards over a fake 8-rank group (2 x 4, ``data`` x ``model``) in
a process of its own (the fake group is its default group). The cells are
cut to batch 8 x seq 32 with the smoke config's 8-token attention chunks
(a ``ShapeSpec`` added to both packages' shape tables in the
subprocesses).

Per device, the argument bytes must be equal and the product FLOPs within
1 % (prefill, decode) and 5 % (train) of the reference's, after the two
differences of the port's program are taken out: the port skips the
attention chunk pairs the causal mask hides entirely (the reference
computes all of them), and it recomputes each cross-entropy chunk's
logits in the backward pass (the reference saves them). Each record
renders in ``benchmarks/roofline_table``.
"""
import json
import os
import subprocess
import sys

import pytest

from repro_torch.configs import get_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH, BATCH, SEQ = "internlm2-1.8b", 8, 32
KINDS = ("train", "prefill", "decode")

_REFERENCE = r"""
import json, sys
from repro.analysis import analyze_module
from repro.configs import ShapeSpec, SHAPES, get_config
import repro.launch.dryrun as D
from repro.launch.mesh import make_mesh
D.get_config = lambda arch: get_config(arch, smoke=True)
mesh = make_mesh((2, 4), ("data", "model"))
out = {}
for kind in ("train", "prefill", "decode"):
    SHAPES[kind] = ShapeSpec(kind, %(seq)d, %(batch)d, kind)
    lowered, cfg, meta = D.lower_cell("%(arch)s", kind, mesh)
    c = lowered.compile()
    m = c.memory_analysis()
    out[kind] = {"argument_bytes": m.argument_size_in_bytes,
                 "flops": analyze_module(c.as_text(), default_group=4).flops}
print(json.dumps(out))
"""

_PORT = r"""
import json
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.configs import ShapeSpec
from repro_torch.launch import dryrun
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
out = {}
for kind in ("train", "prefill", "decode"):
    out[kind] = dryrun.run_cell("%(arch)s", kind, multi_pod=False, mesh=mesh,
                                smoke=True,
                                spec=ShapeSpec(kind, %(seq)d, %(batch)d, kind))
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def records():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    args = {"arch": ARCH, "seq": SEQ, "batch": BATCH}
    procs = {name: subprocess.Popen(
        [sys.executable, "-c", script % args], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT)
        for name, script in (("ref", _REFERENCE), ("port", _PORT))}
    out = {}
    for name, p in procs.items():
        stdout, stderr = p.communicate(timeout=240)
        assert p.returncode == 0, f"{name}: {stderr[-3000:]}"
        out[name] = json.loads(stdout.strip().splitlines()[-1])
    return out


def _attributed(kind: str) -> float:
    """The port's product FLOPs minus the reference's that the two
    programs' differences account for, per device (2 data x 4 model)."""
    cfg = get_config(ARCH, smoke=True)
    b_loc, heads = BATCH // 2, cfg.n_heads // 4
    c, dh = cfg.attn_chunk, cfg.dh
    nq = SEQ // c
    skipped = nq * (nq - 1) // 2 * cfg.n_layers
    pair = 2 * c * c * dh * b_loc * heads        # one chunk-pair product
    if kind == "prefill":
        return -skipped * 2 * pair               # scores + values
    if kind == "train":
        # forward 2, recomputed 2, backward 4 products a pair
        ce = 2 * b_loc * (-(-SEQ // 512) * 512) * cfg.d_model \
            * (cfg.vocab // 4)                   # one recomputed logits
        return ce - skipped * 8 * pair
    return 0.0


@pytest.mark.parametrize("kind", KINDS)
def test_argument_bytes_equal_reference(records, kind):
    assert records["port"][kind]["memory"]["argument_bytes"] == \
        records["ref"][kind]["argument_bytes"]


@pytest.mark.parametrize("kind", KINDS)
def test_product_flops_match_reference(records, kind):
    ref = records["ref"][kind]["flops"]
    got = records["port"][kind]["roofline"]["flops"]
    tol = 0.05 if kind == "train" else 0.01
    assert abs(got - (ref + _attributed(kind))) <= tol * ref, \
        (kind, got, ref, _attributed(kind))


@pytest.mark.parametrize("kind", KINDS)
def test_record_has_the_reference_keys_and_renders(records, kind, tmp_path,
                                                   capsys):
    sys.path.insert(0, ROOT)
    from benchmarks import roofline_table

    rec = records["port"][kind]
    for k in ("argument_bytes", "output_bytes", "temp_bytes",
              "alias_bytes", "live_bytes"):
        assert k in rec["memory"]
    m = rec["memory"]
    assert m["alias_bytes"] == 0              # the eager step donates nothing
    assert m["live_bytes"] == m["argument_bytes"] + m["temp_bytes"]
    assert rec["ok"] and rec["n_devices"] == 8 and rec["mesh"] == "2x4"
    assert "modeled" in rec["hw"]
    path = tmp_path / "dryrun.jsonl"
    path.write_text(json.dumps(rec) + "\n")
    assert roofline_table.main(path=str(path)) == 0
    assert f"{ARCH}" in capsys.readouterr().out
