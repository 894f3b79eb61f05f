"""The published RWKV-6 "Finch" block (``ModelConfig.rwkv_block="finch"``)
on the CPU, against the benchmark's plain float32 reference
(``perfbench/reference/rwkv6.py``, which imports nothing of the port), on
seeded random weights at a small size: one block's output and gradients,
the whole model's loss and every leaf's gradient, prefill and decode
through the recurrent state against the full forward, the group norm's
eps read from the config, the scan counter ``scan_paths()``, the spans
of the time mix and channel mix, the exact parameter count and ``train()``
through the normal path.

Tolerances, float32 throughout: the port and the reference compute the
same equations, the port's scan the kernel's plain loop (``ref.py``) and
the reference its own loop, so they differ by the order of float32 sums
alone; 1e-5 of the largest magnitude holds that with room (the largest
gap seen, 2.5e-6 of the leaf's norm, is in ``u``'s gradient, a sum over
every position).
"""
import dataclasses
import gc
import sys
import types
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench.reference import rwkv6 as plain  # noqa: E402
from perfbench.reference.train import loss_and_grads  # noqa: E402
from repro_torch import _tree  # noqa: E402
from repro_torch import telemetry as tel  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed import sharding as S  # noqa: E402
from repro_torch.launch.train import TrainConfig, train  # noqa: E402
from repro_torch.models import ModelConfig, build  # noqa: E402
from repro_torch.models import recurrent, transformer  # noqa: E402
from repro_torch.models.common import InitKey  # noqa: E402

RTOL = 1e-5
B, S_LEN = 2, 24


def finch(dtype="float32", **over) -> ModelConfig:
    """The smoke config's sizes (d 64, 4 heads of 16, 2 layers) with the
    published block."""
    return dataclasses.replace(get_config("rwkv6-3b", smoke=True),
                               rwkv_block="finch",
                               dtype=dtype, **over)


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v for k in sorted(tree)
                for k2, v in flat(tree[k], f"{prefix}{k}.").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v for i, t in enumerate(tree)
                for k2, v in flat(t, f"{prefix}{i}.").items()}
    return {prefix[:-1]: tree}


def model_dict(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def _close(got, ref, what=""):
    got, ref = got.detach(), ref.detach()
    tol = RTOL * float(ref.abs().max()) + 1e-12
    assert float((got - ref).abs().max()) <= tol, what


@pytest.fixture(scope="module")
def setup():
    """A Finch model, its parameters with every leaf drawn off its init
    (so no gradient is zero by symmetry) and a batch."""
    cfg = finch()
    model = build(cfg)
    gen = torch.Generator().manual_seed(0)
    params = _tree.tree_map(
        lambda p: p + 0.05 * torch.randn(p.shape, generator=gen),
        model.init(0, device="cpu"))
    batch = {"tokens": torch.randint(0, cfg.vocab, (B, S_LEN), generator=gen),
             "labels": torch.randint(0, cfg.vocab, (B, S_LEN), generator=gen)}
    return cfg, model, params, batch


def test_specs_are_the_programs_tree(setup):
    cfg, model, params, _ = setup
    specs = plain.param_specs(model_dict(cfg))
    got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
           for k, v in flat(params).items()}
    assert got == {k: (s[0], s[1]) for k, s in specs.items()}


def test_block_and_its_gradients_match_reference(setup):
    cfg, _, params, _ = setup
    layer = _tree.tree_map(lambda a: a[0].detach().requires_grad_(),
                           params["main"]["sub0"])
    L = {k: v for k, v in flat(layer).items()}
    x = torch.randn(B, S_LEN, cfg.d_model,
                    generator=torch.Generator().manual_seed(1),
                    requires_grad=True)
    pos = transformer._positions(B, S_LEN, "cpu")
    got, _, _ = transformer._apply_block(layer, x, pos, "rwkv", cfg,
                                         use_moe=False)
    ref = plain.block(L, x, model_dict(cfg), "f32")
    _close(got, ref, "output")
    dy = torch.randn(got.shape, generator=torch.Generator().manual_seed(2))
    names = sorted(L)
    g_got = torch.autograd.grad(got, [x] + [L[k] for k in names], dy)
    g_ref = torch.autograd.grad(ref, [x] + [L[k] for k in names], dy)
    for name, a, b in zip(["x"] + names, g_got, g_ref):
        _close(a, b, name)


def test_model_loss_and_gradients_match_reference(setup):
    cfg, model, params, batch = setup
    (loss, _), grads = _tree.value_and_grad(model.loss, params, batch,
                                            has_aux=True)
    P = {k: v.detach().clone() for k, v in flat(params).items()}
    ref_loss, ref_grads = loss_and_grads(plain, model_dict(cfg), P, batch,
                                         "f32")
    assert float(loss) == pytest.approx(ref_loss, rel=RTOL)
    got = flat(grads)
    assert set(got) == set(ref_grads)
    for k, g in ref_grads.items():
        _close(got[k], g, k)


def test_prefill_then_decode_equal_the_full_forward(setup):
    """The full forward's logits at every position against (a) a prefill
    of the first half through each block's recurrent state and then one
    step at a time, and (b) ``decode_step`` from empty caches."""
    cfg, model, params, batch = setup
    tokens = batch["tokens"]
    with torch.no_grad():
        pos = transformer._positions(B, S_LEN, "cpu")
        x = transformer.embed(params["embed"], tokens, cfg)
        h, _ = model._trunk(params, x, pos)
        full = transformer.unembed(params["embed"], h, cfg)
        # (a) blocks driven through their states: prefill, then steps
        half = S_LEN // 2
        caches = model.init_caches(B, S_LEN, device="cpu")["main"]["sub0"]
        layers = transformer._unstack(params["main"], cfg.n_layers)
        outs = []
        for lo, hi in [(0, half)] + [(t, t + 1) for t in range(half, S_LEN)]:
            xs = x[:, lo:hi]
            for i, lp in enumerate(layers):
                cache = _tree.tree_map(lambda a: a[i], caches)
                xs, new, _ = transformer._apply_block(
                    lp["sub0"], xs, pos[:, lo:hi], "rwkv", cfg,
                    use_moe=False, cache=cache)
                transformer._store(cache, new)
            outs.append(xs)
        hs = transformer.rms_norm(torch.cat(outs, 1), params["final_ln"],
                                  cfg.norm_eps)
        _close(transformer.unembed(params["embed"], hs, cfg), full,
               "prefill and steps")
        # (b) the serving path's decode steps
        caches = model.init_caches(B, S_LEN, device="cpu")
        for t in range(S_LEN):
            logits, caches = model.decode_step(params, tokens[:, t:t + 1],
                                               caches, t)
            _close(logits[:, 0], full[:, t], f"decode step {t}")


@pytest.mark.parametrize("block", ["simplified", "finch"])
def test_group_norm_reads_its_eps_from_the_config(block, monkeypatch):
    """The eps follows ``rwkv_block``: Finch's 6.4e-4, the JAX package's
    1e-5; the mixer reads it from ``recurrent.GN_EPS``."""
    assert recurrent.GN_EPS == {"finch": 6.4e-4, "simplified": 1e-5}
    assert plain.GN_EPS == recurrent.GN_EPS["finch"]
    cfg = dataclasses.replace(finch(), rwkv_block=block)
    params = recurrent.init_rwkv(InitKey.from_seed(3, "cpu"), cfg)
    x = torch.randn(B, S_LEN, cfg.d_model,
                    generator=torch.Generator().manual_seed(4))
    outs = {}
    for eps in (1e-5, 6.4e-4, 1.0):
        monkeypatch.setitem(recurrent.GN_EPS, block, eps)
        outs[eps] = recurrent.rwkv_mixer(params, x, cfg)
    assert not torch.allclose(outs[1e-5], outs[1.0])
    assert not torch.equal(outs[1e-5], outs[6.4e-4])
    if block == "finch":
        L = {f"mixer.{k}": v for k, v in params.items()}
        for eps, got in outs.items():
            monkeypatch.setattr(plain, "GN_EPS", eps)
            _close(got, plain.time_mix(L, x, model_dict(cfg), "f32"),
                   f"eps {eps}")
    assert ModelConfig.__dataclass_fields__["rwkv_block"].default == \
        "simplified"
    assert get_config("rwkv6-3b").rwkv_block == "finch"


def test_scan_paths_count_calls_by_path(setup, monkeypatch):
    cfg, model, params, batch = setup
    recurrent.reset_scan_paths()
    with torch.no_grad():
        model.loss(params, batch)
    assert recurrent.scan_paths() == {"kernel": 0, "plain": cfg.n_layers}
    # a training step's backward makes no call of its own
    _tree.value_and_grad(model.loss, params, batch, has_aux=True)
    assert recurrent.scan_paths() == {"kernel": 0,
                                      "plain": 2 * cfg.n_layers}
    # a call on CUDA tensors counts as the kernel's (the scan stubbed)
    monkeypatch.setattr(recurrent, "_wkv6_scan_local",
                        lambda *a: ("y", "s"))
    cuda = types.SimpleNamespace(device=torch.device("cuda"))
    assert recurrent._scan(cuda, None, None, None, None, None) == ("y", "s")
    assert recurrent.scan_paths() == {"kernel": 1,
                                      "plain": 2 * cfg.n_layers}
    recurrent.reset_scan_paths()
    assert recurrent.scan_paths() == {"kernel": 0, "plain": 0}


def test_spans_of_the_time_mix_and_channel_mix(setup):
    """With telemetry on, a training step holds in each layer's forward a
    ``model.mixer`` span (``model.ddlerp`` and ``model.wkv6`` inside it)
    and a ``model.channel_mix`` span, and in its backward one interval of
    each on the autograd thread, the scan's and the mixes' inside the
    mixer's."""
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import AdamWConfig, adamw_init

    cfg, model, params, batch = setup
    step = make_train_step(model, AdamWConfig(lr=1e-3))
    tel.reset()
    tel.enable()
    try:
        step(params, adamw_init(params), batch)
        (root,) = tel.get_tracer().roots
    finally:
        tel.reset()
        tel.disable()
    fwd, bwd = root.children[:2]
    n = cfg.n_layers
    assert [c.name for c in fwd.children] == ["model.mixer",
                                              "model.channel_mix"] * n
    for m in fwd.children[::2]:
        assert [c.name for c in m.children] == ["model.ddlerp", "model.wkv6"]
    names = [c.name for c in bwd.children]
    for name in ("model.channel_mix.backward", "model.mixer.backward",
                 "model.wkv6.backward", "model.ddlerp.backward"):
        assert names.count(name) == n, name
    by = lambda name: [c for c in bwd.children if c.name == name]
    for mix, scan, dd in zip(by("model.mixer.backward"),
                             by("model.wkv6.backward"),
                             by("model.ddlerp.backward")):
        for inner in (scan, dd):
            assert mix.t_start <= inner.t_start <= inner.t_end <= mix.t_end
        assert scan.t_end <= dd.t_start


def test_traced_step_leaves_no_tensor_to_the_garbage_collector(setup):
    """With spans on (the backward intervals' gradient hooks in place), a
    step's graph and activations are freed by reference counting: none
    is left in a cycle for a collection."""
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import AdamWConfig, adamw_init

    cfg, model, params, batch = setup
    step = make_train_step(model, AdamWConfig(lr=1e-3))
    opt = adamw_init(params)
    step(params, opt, batch)        # a process's first step leaves some
    gc.collect()
    tel.reset()
    tel.enable()
    gc.disable()
    gc.set_debug(gc.DEBUG_SAVEALL)
    try:
        step(params, opt, batch)
        gc.collect()
        left = [o for o in gc.garbage if isinstance(o, torch.Tensor)]
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
        gc.enable()
        tel.reset()
        tel.disable()
    assert left == []


def test_telemetry_off_makes_the_same_step(setup):
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import AdamWConfig, adamw_init

    cfg, model, params, batch = setup
    step = make_train_step(model, AdamWConfig(lr=1e-3))
    off = step(params, adamw_init(params), batch)
    tel.reset()
    tel.enable()
    try:
        on = step(params, adamw_init(params), batch)
    finally:
        tel.reset()
        tel.disable()
    for a, b in zip(_tree.leaves(off[0]), _tree.leaves(on[0])):
        assert torch.equal(a, b)


def test_param_count_is_exact():
    full = get_config("rwkv6-3b")
    assert full.rwkv_block == "finch"
    leaves = _tree.leaves(build(full).init(InitKey.abstract()))
    assert full.param_count() == sum(p.numel() for p in leaves) \
        == 3_099_855_360
    small = finch()
    assert small.param_count() == sum(
        p.numel() for p in _tree.leaves(build(small).init(0, device="cpu")))


@pytest.mark.parametrize("over", [
    {"rwkv_block": "finch-7"},
    {"rwkv_block": "finch", "pattern": ("rwkv", "attn")},
])
def test_config_refuses_what_the_block_cannot_build(over):
    with pytest.raises(ValueError):
        dataclasses.replace(get_config("rwkv6-3b", smoke=True), **over)


def test_finch_leaves_each_get_a_sharding_spec():
    """The full Finch tree on a 16 x 16 mesh: every leaf a spec, the
    projections split as the attention's are, the new leaves whole."""
    cfg = get_config("rwkv6-3b")
    params = build(cfg).init(InitKey.abstract())
    mesh = types.SimpleNamespace(shape={"data": 16, "model": 16},
                                 axis_names=("data", "model"))
    leaves = S.spec_leaves(S.param_shardings(params, cfg, mesh, fsdp=False))
    paths = list(flat(params))
    assert len(leaves) == len(paths)
    specs = dict(zip(paths, leaves))
    t = "main.sub0.mixer."
    assert tuple(specs[t + "wr"]) == (None, None, "model")
    assert tuple(specs[t + "wo"]) == (None, "model", None)
    for leaf in ("maa_w1", "maa_w2", "decay_w1", "decay_w2", "ln_x_b"):
        assert all(p is None for p in specs[t + leaf]), leaf


def test_train_runs_the_finch_block_through_the_normal_path():
    cfg = finch("bfloat16")
    seen = []
    out = train(TrainConfig(arch="rwkv6-3b", steps=3, batch=2, seq=16,
                            device="cpu", log_every=10),
                hooks={"on_end": lambda p, o: seen.append(p)},
                model_cfg=cfg)
    assert torch.isfinite(torch.tensor(out["loss"]))
    mixer = seen[0]["main"]["sub0"]["mixer"]
    assert {"maa_w1", "maa_w2", "decay_w1", "decay_w2", "ln_x_b"} <= \
        set(mixer)
    assert "ln1_b" in seen[0]["main"]["sub0"]
