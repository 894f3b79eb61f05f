"""The LM stack's launchers in the port: the token stream, the train step
and loop, checkpoints across the packages, the server, model FLOPs, and
the entry points' device rule.

* ``synthetic_batch`` is a pure function of (seed, step) and follows the
  reference's transition rule on its non-noise positions (its bits are
  its own: numpy's generator, not ``jax.random``).
* ``make_train_step`` (1 and 2 microbatches) against the reference's on
  the same f32 weights and batch: metrics within rtol 1e-5, the updated
  weights within 1e-4 * max|ref leaf| (AdamW's eps at 1e-3, see there).
* the train loop (``device="cpu"``) learns, recovers from a fault, resumes
  after a restart, and a run with a fault ends on the same weights as one
  without (the cases of ``test_launch_loops.py``).
* a checkpoint written by the reference's ``CheckpointManager`` restores
  in the port leaf for leaf, and the reverse (bf16 leaves included).
* ``Server``'s greedy outputs equal the direct decode chain; mixed prompt
  lengths are served.
* ``model_flops`` and ``useful_ratio`` equal the reference's.
* every entry point raises without CUDA unless given ``device="cpu"``.
"""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro import checkpoint as jx_ckpt
from repro.analysis.roofline import RooflineTerms as JxRooflineTerms
from repro.analysis.roofline import model_flops as jx_model_flops
from repro.configs import get_config as jx_get_config
from repro.data.tokens import synthetic_batch as jx_synthetic_batch
from repro.launch.steps import batch_struct as jx_batch_struct
from repro.launch.steps import make_train_step as jx_make_train_step
from repro.models import build as jx_build
from repro.optim import AdamWConfig as JxAdamWConfig
from repro.optim import adamw_init as jx_adamw_init
from _lm_cases import jax_form
from repro_torch import _tree
from repro_torch.analysis.roofline import H100, RooflineTerms, model_flops
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ARCHS, get_config
from repro_torch.data import TokenStream, synthetic_batch
from repro_torch.examples import lm_train
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.launch.serve import Request, Server
from repro_torch.launch.steps import batch_struct, make_train_step
from repro_torch.launch.train import TrainConfig, train
from repro_torch.models import attention, build, params_from_numpy
from repro_torch.models import recurrent
from repro_torch.optim import AdamWConfig, adamw_init


class _Fault(Exception):
    pass


def _cfg(**kw) -> TrainConfig:
    base = dict(arch="internlm2-1.8b", smoke=True, steps=8, batch=2, seq=16,
                log_every=100, device="cpu")
    return TrainConfig(**(base | kw))


# ------------------------------------------------------------ tokens
@pytest.mark.parametrize("seed,step", [(0, 0), (0, 7), (3, 1)])
def test_synthetic_batch_is_deterministic_and_follows_the_rule(seed, step):
    vocab, b, s = 97, 16, 64
    a = synthetic_batch(vocab, b, s, seed, step)
    again = TokenStream(vocab, b, s, seed).batch_at(step)
    assert all(torch.equal(a[k], again[k]) for k in ("tokens", "labels"))
    other = synthetic_batch(vocab, b, s, seed, step + 1)
    assert not torch.equal(a["tokens"], other["tokens"])
    for batch in (a, {k: torch.from_numpy(np.array(v)) for k, v in
                      jx_synthetic_batch(vocab, b, s, seed, step).items()}):
        tok, lab = batch["tokens"].long(), batch["labels"].long()
        assert batch["tokens"].dtype == torch.int32
        assert tok.shape == (b, s) and bool((tok >= 0).all()) and bool(
            (tok < vocab).all())
        assert torch.equal(lab[:, :-1], tok[:, 1:])
        assert bool((lab[:, -1] == -1).all())
        prev, nxt = tok[:, :-1], tok[:, 1:]
        rule = nxt == (prev * 7 + 1) % vocab
        noise = nxt == (prev * 31 + 17) % vocab
        assert bool((rule | noise).all())
        assert 0.05 < 1.0 - float(rule.float().mean()) < 0.3


# ------------------------------------------------------------ train step
@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_reference(accum):
    arch = "internlm2-1.8b"
    jcfg = dataclasses.replace(jx_get_config(arch, smoke=True),
                               dtype="float32")
    tcfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    jm, tm = jx_build(jcfg), build(tcfg)
    jp = jm.init(jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    nb = {k: np.asarray(v) for k, v in
          jx_synthetic_batch(jcfg.vocab, 4, 16, 0, 0).items()}
    # eps 1e-3 keeps the first AdamW step a smooth function of the
    # gradient: at 1e-8 it is sign(g) * lr, and a gradient element within
    # rounding of 0 moves its weight by up to 2 * lr between packages
    opt = dict(lr=1e-2, warmup=1, eps=1e-3)
    jstep = jax.jit(jx_make_train_step(jm, JxAdamWConfig(**opt),
                                       accum_steps=accum))
    jp2, _, jmet = jstep(jp, jx_adamw_init(jp),
                         {k: jnp.asarray(v) for k, v in nb.items()})
    tstep = make_train_step(tm, AdamWConfig(**opt), accum_steps=accum)
    tp2, state, tmet = tstep(tp, adamw_init(tp), params_from_numpy(
        nb, device="cpu"))
    assert int(state["step"]) == 1
    for k in ("loss", "gnorm", "ce", "load_balance"):
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                   rtol=1e-5, atol=1e-7)
    for g, r in zip(_tree.leaves(tp2), jax.tree.leaves(jp2)):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=0,
                                   atol=1e-4 * np.abs(r).max())


def test_batch_struct_matches_reference():
    for arch in ("whisper-base", "qwen2-vl-2b", "internlm2-1.8b"):
        ref = jx_batch_struct(jx_get_config(arch), 4, 32)
        got = batch_struct(get_config(arch), 4, 32)
        assert set(got) == set(ref)
        for k, (shape, dtype) in got.items():
            assert shape == ref[k].shape
            assert str(dtype).split(".")[-1] == str(ref[k].dtype)


# ------------------------------------------------------------ train loop
def test_train_learns_and_checkpoints(tmp_path):
    losses = []
    out = train(_cfg(steps=24, lr=1e-2, ckpt_dir=str(tmp_path),
                     ckpt_every=4),
                hooks={"on_step": lambda s, m: losses.append(
                    float(m["loss"]))})
    assert out["last_step"] == 23 and len(losses) == 24
    assert all(np.isfinite(losses))
    assert np.mean(losses[-4:]) < np.mean(losses[:4])
    assert any(p.name.startswith("step_") for p in tmp_path.iterdir())


def test_train_fault_recovery_is_exact(tmp_path):
    """A fault at step 5 restores the latest checkpoint and replays from
    there; the run ends on exactly the metrics of a run without one."""
    fired = {"done": False}

    def fault(step):
        if step == 5 and not fired["done"]:
            fired["done"] = True
            raise _Fault("injected")

    seen = []
    out = train(_cfg(ckpt_dir=str(tmp_path / "a"), ckpt_every=2),
                hooks={"fault": fault, "on_step": lambda s, m: seen.append(s)})
    assert out["last_step"] == 7 and fired["done"]
    # the replay starts after the latest checkpoint whose background write
    # had finished (step 2 or 4)
    assert seen[:5] == [0, 1, 2, 3, 4] and seen[-3:] == [5, 6, 7]
    assert seen[5] in (3, 5)
    clean = train(_cfg(ckpt_dir=str(tmp_path / "b"), ckpt_every=2))
    assert out == clean


def test_train_resume_continues(tmp_path):
    train(_cfg(steps=4, ckpt_dir=str(tmp_path), ckpt_every=2))
    seen = []
    train(_cfg(steps=7, ckpt_dir=str(tmp_path), ckpt_every=2),
          hooks={"on_step": lambda s, m: seen.append(s)})
    assert seen and seen[0] == 5          # resumed after the step-4 ckpt


def test_train_mesh_is_one_card(monkeypatch):
    """``mesh=""`` trains on one card, with no process group and no
    DTensor. A "DxM" mesh trains over the running group (started by
    torchrun or ``launch.mesh.spawn``; tests/test_torch_lm_mesh.py): with
    none running and no torchrun environment, it raises before a group
    starts."""
    assert train(_cfg(steps=1, mesh=""))["last_step"] == 0
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match="RANK"):
        train(_cfg(steps=1, mesh="2x1", dist_backend="gloo"))
    assert not torch.distributed.is_initialized()


def test_cli_trains_and_serves_on_cpu(capsys):
    train_cli.main(["--device", "cpu", "--steps", "3", "--batch", "2",
                    "--seq", "16"])
    assert '"last_step": 2' in capsys.readouterr().out
    serve_cli.main(["--device", "cpu", "--requests", "3", "--max-new", "4"])
    assert "served 3 requests, 12 tokens" in capsys.readouterr().out


# ------------------------------------------------------------ checkpoints
def _jx_tree():
    jm = jx_build(jx_get_config("internlm2-1.8b", smoke=True))
    params = jm.init(jax.random.key(0))
    return {"params": params, "opt": jx_adamw_init(params)}


def test_reference_checkpoint_restores_in_port(tmp_path):
    ref = _jx_tree()
    mgr = jx_ckpt.CheckpointManager(str(tmp_path), every=1)
    mgr.maybe_save(3, ref)              # a background write
    mgr.finalize()
    tm = build(get_config("internlm2-1.8b", smoke=True))
    params = tm.init(1, device="cpu")
    like = {"params": params, "opt": adamw_init(params)}
    got, step = CheckpointManager(str(tmp_path)).restore(like)
    assert step == 3
    flat, tdef = _tree.flatten(got)
    jflat, jdef = jax.tree.flatten(ref)
    assert str(tdef) == str(jdef)
    assert any(t.dtype == torch.bfloat16 for t in flat)
    for t, r in zip(flat, jflat):
        assert t.dtype == params_from_numpy(np.asarray(r), "cpu").dtype
        assert torch.equal(t, params_from_numpy(np.asarray(r), "cpu"))


def test_port_checkpoint_restores_in_reference(tmp_path):
    tm = build(get_config("internlm2-1.8b", smoke=True))
    params = tm.init(2, device="cpu")
    tree = {"params": params, "opt": adamw_init(params)}
    mgr = CheckpointManager(str(tmp_path), every=1)
    mgr.maybe_save(5, tree)
    mgr.finalize()
    got, step = jx_ckpt.CheckpointManager(str(tmp_path)).restore(_jx_tree())
    assert step == 5
    for t, r in zip(_tree.leaves(tree), jax.tree.leaves(got)):
        r = np.asarray(r)
        assert str(r.dtype) == str(t.dtype).split(".")[-1]
        assert torch.equal(params_from_numpy(r, "cpu"), t)


# ------------------------------------------------------------ serving
def test_serve_greedy_matches_direct_decode():
    srv = Server("internlm2-1.8b", smoke=True, slots=2, capacity=32,
                 device="cpu")
    reqs = [Request(i, p, max_new=5)
            for i, p in enumerate([[3, 1, 4], [1, 5, 9]])]
    for r in reqs:
        srv.submit(r)
    srv.run()
    for r in reqs:
        caches = srv.model.init_caches(1, 32, device="cpu")
        with torch.no_grad():
            for p, t in enumerate(r.prompt):
                logits, caches = srv.model.decode_step(
                    srv.params, torch.tensor([[t]]), caches, p)
            got = []
            tok = torch.argmax(logits, dim=-1)
            for n in range(r.max_new):
                got.append(int(tok[0, 0]))
                if n == r.max_new - 1:
                    break
                logits, caches = srv.model.decode_step(
                    srv.params, tok, caches, len(r.prompt) + n)
                tok = torch.argmax(logits, dim=-1)
        assert r.out == got, (r.rid, r.out, got)


def test_serve_buckets_mixed_lengths():
    srv = Server("rwkv6-3b", smoke=True, slots=2, capacity=32, device="cpu")
    reqs = [Request(i, [1] * ln, max_new=3)
            for i, ln in enumerate([2, 2, 4, 4, 4])]
    for r in reqs:
        srv.submit(r)
    assert srv.run() == 15
    assert all(r.done for r in reqs)


# ------------------------------------------------------------ FLOPs
@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_match_reference(arch):
    for kind in ("train", "prefill", "decode"):
        for n in (1, 4096 * 256):
            assert model_flops(jax_form(get_config(arch)), n,
                               kind) == jx_model_flops(jx_get_config(arch),
                                                       n, kind)


def test_useful_ratio_matches_reference():
    for flops in (0.0, 3.5e15):
        vals = dict(compute_s=1.0, memory_s=2.0, collective_s=0.5,
                    flops=flops, hbm_bytes=1e9, collective_bytes=1e6,
                    model_flops=2.1e15)
        got, ref = RooflineTerms(**vals), JxRooflineTerms(**vals)
        assert got.useful_ratio == ref.useful_ratio
        assert got.as_dict() == ref.as_dict()
    assert H100.peak("bf16") == 989.4e12


# ------------------------------------------------------------ devices
@pytest.mark.parametrize("call", [
    "train", "train_cli", "server", "serve_cli", "lm_train", "init",
    "init_caches", "params_from_numpy", "init_gqa_cache", "init_mla_cache",
    "init_rglru_state", "init_rwkv_state"])
def test_lm_entry_points_raise_without_cuda(call, monkeypatch):
    """Asked for the default device on a host without CUDA, an entry point
    raises; it never falls back to the CPU on its own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = build(get_config("internlm2-1.8b", smoke=True))
    mla = get_config("minicpm3-4b", smoke=True)
    rg, rw = (get_config(a, smoke=True) for a in ("recurrentgemma-9b",
                                                   "rwkv6-3b"))
    calls = {
        "train": lambda: train(TrainConfig(steps=1)),
        "train_cli": lambda: train_cli.main(["--steps", "1"]),
        "server": lambda: Server("internlm2-1.8b"),
        "serve_cli": lambda: serve_cli.main([]),
        "lm_train": lambda: lm_train.main(["--steps", "2"]),
        "init": lambda: model.init(0),
        "init_caches": lambda: model.init_caches(1, 8),
        "params_from_numpy": lambda: params_from_numpy({"w": np.ones(2)}),
        "init_gqa_cache": lambda: attention.init_gqa_cache(
            model.cfg, 1, 8, 0),
        "init_mla_cache": lambda: attention.init_mla_cache(mla, 1, 8),
        "init_rglru_state": lambda: recurrent.init_rglru_state(rg, 1),
        "init_rwkv_state": lambda: recurrent.init_rwkv_state(rw, 1),
    }
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[call]()
