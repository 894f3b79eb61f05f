"""The architecture cases the LM parity tests share: one architecture at
one dtype, the reference's weights carried into the port, and decode
steps run on both sides."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import torch

from repro.configs import get_config as jx_get_config
from repro.models import build as jx_build
from repro.models.config import ModelConfig as JxModelConfig
from repro_torch.configs import get_config
from repro_torch.models import build, params_from_numpy

B, S = 2, 16
DECODE_STEPS = 3
# the field the port adds to ModelConfig (rwkv_block)
PORT_FIELDS = tuple(
    f.name for f in dataclasses.fields(get_config("rwkv6-3b"))
    if f.name not in {g.name for g in dataclasses.fields(JxModelConfig)})


def jax_form(cfg):
    """``cfg`` with every field the port adds to ``ModelConfig`` at its
    default, the JAX package's form: the model the JAX package builds
    from the config of the same name (rwkv6-3b's published Finch block
    back to the JAX package's simplified one)."""
    return dataclasses.replace(cfg, **{
        f.name: f.default for f in dataclasses.fields(cfg)
        if f.name in PORT_FIELDS})


def _np_batch(cfg, seed=0) -> dict:
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.is_encdec:
        out["frames"] = rng.normal(size=(B, cfg.encoder.n_frames,
                                         cfg.d_model)).astype(np.float32)
    if cfg.mrope_sections:
        out["mrope_pos"] = np.broadcast_to(
            np.arange(S, dtype=np.int32)[None, None], (3, B, S)).copy()
    return out


class Case:
    """One architecture at one dtype: both models, the reference's
    weights and batch, and its jitted loss and gradients."""

    def __init__(self, arch: str, dtype: str):
        self.arch = arch
        self.jcfg = dataclasses.replace(jx_get_config(arch, smoke=True),
                                        dtype=dtype)
        self.tcfg = dataclasses.replace(get_config(arch, smoke=True),
                                        dtype=dtype)
        self.jm, self.tm = jx_build(self.jcfg), build(self.tcfg)
        self.jp = self.jm.init(jax.random.key(0))
        self.tp = params_from_numpy(jax.tree.map(np.asarray, self.jp),
                                    device="cpu")
        nb = _np_batch(self.jcfg)
        if "frames" in nb:
            nb["frames"] = np.asarray(jnp.asarray(nb["frames"]).astype(
                jnp.dtype(dtype)))
        self.jb = {k: jnp.asarray(v) for k, v in nb.items()}
        self.tb = params_from_numpy(nb, device="cpu")
        (self.jloss, _), self.jgrads = jax.jit(jax.value_and_grad(
            self.jm.loss, has_aux=True))(self.jp, self.jb)


def enc_kvs(case, jax_side: bool):
    if not case.jcfg.is_encdec:
        return None
    if jax_side:
        return case.jm._cross_kvs(case.jp, case.jm.encode(
            case.jp, case.jb["frames"]))
    return case.tm._cross_kvs(case.tp, case.tm.encode(
        case.tp, case.tb["frames"]))


def decode_both(case):
    """Three decode steps on both sides from the same tokens: the
    reference's caches carried into the port after its first step.
    Returns [(port logits, ref logits)] per step."""
    tokens = np.array(case.jb["tokens"])[:, :DECODE_STEPS]
    cap = 8
    jc = case.jm.init_caches(B, cap)
    jkv, tkv = enc_kvs(case, True), enc_kvs(case, False)
    jstep = jax.jit(case.jm.decode_step)
    tc = None
    out = []
    for i in range(DECODE_STEPS):
        jl, jc = jstep(case.jp, jnp.asarray(tokens[:, i:i + 1]), jc,
                       jnp.int32(i), enc_kvs=jkv)
        if i == 0:
            # the reference's caches after step 0 carry across
            tc = params_from_numpy(jax.tree.map(np.asarray, jc),
                                   device="cpu")
            tl = params_from_numpy(np.asarray(jl), device="cpu")
        else:
            with torch.no_grad():
                tl, tc = case.tm.decode_step(
                    case.tp, torch.from_numpy(tokens[:, i:i + 1]), tc, i,
                    enc_kvs=tkv)
        out.append((tl.float().numpy(), np.asarray(jl, np.float32)))
    # the port's own first step from empty caches
    with torch.no_grad():
        t0, _ = case.tm.decode_step(
            case.tp, torch.from_numpy(tokens[:, :1]),
            case.tm.init_caches(B, cap, device="cpu"), 0, enc_kvs=tkv)
    out[0] = (t0.float().numpy(), out[0][1])
    return out


def scale(ref) -> float:
    return float(np.abs(ref).max()) or 1.0
