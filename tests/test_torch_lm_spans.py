"""Spans of the port's LM training step and loop on the CPU: the tree of
``make_train_step`` (one and two microbatches), one ``model.mixer`` a layer
in the forward and one ``model.mixer.backward`` interval a layer inside
``train.backward``, latent attention and recomputed cycles, nothing
registered or made with telemetry off, the same numbers on and off, and
the train CLI's ``--trace`` file."""
import dataclasses
import json

import pytest
import torch

from repro_torch import _tree
from repro_torch import telemetry as tel
from repro_torch.configs import get_config
from repro_torch.data import TokenStream
from repro_torch.launch import train as train_cli
from repro_torch.launch.steps import make_train_step
from repro_torch.models import build
from repro_torch.optim import AdamWConfig, adamw_init


@pytest.fixture(autouse=True)
def _clean_telemetry():
    tel.reset()
    tel.disable()
    yield
    tel.reset()
    tel.disable()


def _setup(arch="internlm2-1.8b", accum_steps=1, batch=2, seq=32, **over):
    cfg = dataclasses.replace(get_config(arch, smoke=True), **over)
    model = build(cfg)
    params = model.init(0, device="cpu")
    step = make_train_step(model, AdamWConfig(lr=1e-3),
                           accum_steps=accum_steps)
    stream = TokenStream(cfg.vocab, batch, seq, 0)
    return cfg, params, adamw_init(params), step, stream


def _within(inner, outer):
    return outer.t_start <= inner.t_start <= inner.t_end <= outer.t_end


@pytest.mark.parametrize("accum_steps", [1, 2])
def test_train_step_span_tree(accum_steps):
    cfg, params, opt, step, stream = _setup(accum_steps=accum_steps)
    tel.enable()
    for i in range(2):
        params, opt, _ = step(params, opt, stream.batch_at(i))
    roots = list(tel.get_tracer().roots)
    assert [(r.name, r.step) for r in roots] == [("train.step", 0),
                                                 ("train.step", 1)]
    phases = ["train.forward", "train.backward"]
    want = phases + ["train.optimizer"] if accum_steps == 1 else \
        (phases + ["train.accumulate"]) * 2 + ["train.accumulate",
                                                 "train.optimizer"]
    for root in roots:
        assert [c.name for c in root.children] == want
        assert all(_within(c, root) for c in root.children)
        assert {s.step for s in root.walk()} == {root.step}
        by = {n: [c for c in root.children if c.name == n] for n in phases}
        for fwd, bwd in zip(*by.values()):
            mixers = [c for c in fwd.children if c.name == "model.mixer"]
            assert len(mixers) == cfg.n_layers == len(fwd.children)
            assert all(m.attrs == {"kind": "attn"} for m in mixers)
            back = bwd.children
            assert [b.name for b in back] == \
                ["model.mixer.backward"] * cfg.n_layers
            assert all(_within(b, bwd) and b.parent is bwd for b in back)
            # the backward meets the layers last to first, one at a time
            assert all(a.t_end <= b.t_start for a, b in zip(back, back[1:]))


def test_off_registers_no_hook_and_makes_no_span(monkeypatch):
    """Telemetry off: no gradient hook, no span, and the step's numbers
    are those of the step with telemetry on."""
    cfg, params, opt, step, stream = _setup()
    hooks = []
    register = torch.Tensor.register_hook
    monkeypatch.setattr(torch.Tensor, "register_hook",
                        lambda t, fn: hooks.append(fn) or register(t, fn))
    batch = stream.batch_at(0)
    off = step(params, opt, batch)
    assert hooks == [] and not tel.get_tracer().roots
    assert tel.get_tracer().summary() == {}
    tel.enable()
    on = step(params, opt, batch)
    assert len(hooks) == 2 * cfg.n_layers
    assert len(tel.get_tracer().roots) == 1
    for a, b in zip(_tree.leaves(off), _tree.leaves(on)):
        assert torch.equal(a, b)


def test_latent_attention_and_recomputed_cycles():
    """minicpm3 (latent attention), each cycle recomputed in the backward
    as at its full size: its mixers are ``mla``; the recomputation's
    ``model.mixer`` spans and every backward interval lie inside
    ``train.backward``."""
    cfg, params, opt, step, stream = _setup("minicpm3-4b", remat="full")
    assert cfg.mla
    tel.enable()
    step(params, opt, stream.batch_at(0))
    (root,) = tel.get_tracer().roots
    fwd, bwd, _ = root.children
    assert [m.attrs["kind"] for m in fwd.children] == ["mla"] * cfg.n_layers
    back = [c for c in bwd.children if c.name == "model.mixer.backward"]
    again = [c for c in bwd.children if c.name == "model.mixer"]
    assert len(back) == cfg.n_layers == len(again)
    assert all(_within(c, bwd) for c in bwd.children)


def test_train_cli_trace_file(tmp_path):
    """``--trace``: three steps of the smoke config, each a ``train.step``
    tree beside the loop's ``train.batch``, ``train.log`` and
    ``train.checkpoint``."""
    path = tmp_path / "spans.jsonl"
    train_cli.main(["--device", "cpu", "--steps", "3", "--batch", "2",
                    "--seq", "32", "--log-every", "2", "--ckpt-dir",
                    str(tmp_path / "ckpt"), "--ckpt-every", "2",
                    "--trace", str(path)])
    trees = [json.loads(line) for line in path.read_text().splitlines()]
    names = [t["name"] for t in trees]
    assert names.count("train.step") == 3
    assert names.count("train.batch") == 3
    assert names.count("train.checkpoint") == 3
    assert [t["step"] for t in trees if t["name"] == "train.log"] == [0, 2]
    steps = [t for t in trees if t["name"] == "train.step"]
    assert [t["step"] for t in steps] == [0, 1, 2]
    for t in steps:
        assert [c["name"] for c in t["children"]] == [
            "train.forward", "train.backward", "train.optimizer"]
        assert t["wall_ns"] > 0 and t["tid"] > 0
        bwd = t["children"][1]
        assert {c["name"] for c in bwd["children"]} == {
            "model.mixer.backward"}
    assert tel.enabled()
