"""The port's dry run against the reference's, on the smoke cells of
internlm2-1.8b (attention), rwkv6-3b (the RWKV-6 scan) and
recurrentgemma-9b (the RG-LRU scan and local attention).

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
1 % (prefill, decode) and 5 % (train) of the reference's, after the
differences of the port's program are taken out (``_attributed``,
``_attributed_bytes``): the port skips the attention chunk pairs the
causal mask or the local window hides entirely (the reference computes all
of them), it recomputes each cross-entropy chunk's logits in the backward
pass (the reference saves them) and takes the hidden state's gradient
there from two products, of the logits' gradient rounded and of its
rounding error (``transformer._FloatLogits``), and its eager decode step of an
attention-free model holds the position scalar the reference's jit drops
as unused. The scans are one op each and charged by
``analysis.opcount``'s rule, the reference's scan-body products times its
trips. Each record renders in ``benchmarks/roofline_table``.
"""
import json
import os
import subprocess
import sys

import pytest

from repro_torch.configs import get_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("internlm2-1.8b", "rwkv6-3b", "recurrentgemma-9b")
BATCH, SEQ = 8, 32
KINDS = ("train", "prefill", "decode")
# internlm2's cases keep their ids of one architecture
CELLS = [pytest.param(a, k, id=k if a == ARCHS[0] else f"{a}-{k}")
         for a in ARCHS for k in KINDS]

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


_RECORDS = {}


def _records(arch: str) -> dict:
    """Both packages' records of ``arch``'s three cells, run once a
    module."""
    if arch not in _RECORDS:
        _RECORDS[arch] = _run(arch)
    return _RECORDS[arch]


@pytest.fixture(scope="module")
def records():
    yield _records
    _RECORDS.clear()


def _run(arch: str) -> dict:
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    args = {"arch": arch, "seq": SEQ, "batch": BATCH}
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


def _hidden_pairs(cfg) -> int:
    """Attention chunk pairs (query chunk i, key chunk j) the port skips
    over all layers: every key after every query (j c > i c + c - 1), or,
    in a windowed layer, every key at least ``window`` before every query
    (i c - (j c + c - 1) >= window)."""
    c, nq = cfg.attn_chunk, SEQ // cfg.attn_chunk
    hidden = 0
    for i in range(cfg.n_layers):
        kind = cfg.pattern[i % len(cfg.pattern)]
        if kind not in ("attn", "local"):
            continue
        window = cfg.local_window if kind == "local" else cfg.window
        hidden += sum(1 for q in range(nq) for k in range(nq)
                      if k > q or (window and q * c - (k * c + c - 1)
                                   >= window))
    return hidden


def _attributed(arch: str, kind: str) -> float:
    """The port's product FLOPs minus the reference's that the two
    programs' differences account for, per device (2 data x 4 model)."""
    cfg = get_config(arch, smoke=True)
    b_loc, heads = BATCH // 2, cfg.n_heads // 4
    c, dh = cfg.attn_chunk, cfg.dh
    skipped = _hidden_pairs(cfg)
    pair = 2 * c * c * dh * b_loc * heads        # one chunk-pair product
    if kind == "prefill":
        return -skipped * 2 * pair               # scores + values
    if kind == "train":
        # forward 2, recomputed 2, backward 4 products a pair
        ce = 2 * b_loc * (-(-SEQ // 512) * 512) * cfg.d_model \
            * (cfg.vocab // 4)                   # one logits product
        # the recomputed logits and the hidden state's second product
        return 2 * ce - skipped * 8 * pair
    return 0.0


def _attributed_bytes(arch: str, kind: str) -> int:
    """The port's argument bytes minus the reference's: an
    attention-free model's decode step never reads its position (an
    int32 scalar), so the reference's jit drops that argument; the
    port's eager step is handed it."""
    cfg = get_config(arch, smoke=True)
    attention_free = not {"attn", "local"} & set(cfg.pattern)
    return 4 if kind == "decode" and attention_free else 0


@pytest.mark.parametrize("arch, kind", CELLS)
def test_argument_bytes_equal_reference(records, arch, kind):
    rec = records(arch)
    assert rec["port"][kind]["memory"]["argument_bytes"] == \
        rec["ref"][kind]["argument_bytes"] + _attributed_bytes(arch, kind)


@pytest.mark.parametrize("arch, kind", CELLS)
def test_product_flops_match_reference(records, arch, kind):
    rec = records(arch)
    ref = rec["ref"][kind]["flops"]
    got = rec["port"][kind]["roofline"]["flops"]
    tol = 0.05 if kind == "train" else 0.01
    assert abs(got - (ref + _attributed(arch, kind))) <= tol * ref, \
        (arch, kind, got, ref, _attributed(arch, kind))


@pytest.mark.parametrize("arch, kind", CELLS)
def test_record_has_the_reference_keys_and_renders(records, arch, kind,
                                                   tmp_path, capsys):
    sys.path.insert(0, ROOT)
    from benchmarks import roofline_table

    rec = records(arch)["port"][kind]
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
    assert f"{arch}" in capsys.readouterr().out
