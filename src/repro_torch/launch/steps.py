"""Step-function builders shared by the trainer and the server.

The counterpart of ``repro.launch.steps``. ``make_train_step`` closes over
(model, optimizer config, activation rules) and returns a (params,
opt_state, batch) -> (params, opt_state, metrics) function: the loss's
value and gradients (``_tree.value_and_grad``), then AdamW.
``make_serve_step`` returns the single-token decode step. The steps run
eagerly: ``jax.jit`` has no counterpart here.
"""
from __future__ import annotations

import itertools

import torch

from .. import _tree
from .. import telemetry as tel
from ..distributed import sharding
from ..models import Transformer, activation_sharding
from ..models.common import dtype_of
from ..models.config import ModelConfig
from ..optim import AdamWConfig, adamw_update


def make_train_step(model: Transformer, opt_cfg: AdamWConfig,
                    act_rules: dict | None = None, accum_steps: int = 1,
                    shardings=None):
    """``accum_steps`` > 1: microbatched gradient accumulation -- the
    global batch is split on the leading dim; one optimizer update per
    outer step.

    ``shardings``: ``(mesh, param_specs, moment_specs)`` for DTensor
    parameters and moments on a ``DeviceMesh``. The gradients are then
    moved once to the moments' placements (ZeRO-1: a reduce-scatter over
    the data axes where the moment is sharded and the parameter is not),
    the norm and the update run on those blocks, and every new parameter
    and moment is put back to its spec (the reference's ``out_shardings``;
    an all-gather where the parameter is replicated). The metrics come
    back as plain tensors.

    While telemetry records (``telemetry.recording()``), each call is a
    ``train.step`` span (attr ``step``: the calls so far) over
    ``train.forward`` (the loss), ``train.backward`` (``autograd.grad``,
    the anchor of the autograd thread's spans), ``train.accumulate`` (the
    microbatch sums), ``train.redistribute`` (with ``shardings``) and
    ``train.optimizer`` (AdamW, the clipping norm included). The spans
    launch, synchronise and allocate nothing."""
    rules = act_rules or {}
    calls = itertools.count()

    def grad_fn(params, batch):
        with activation_sharding(rules):
            return _tree.value_and_grad(
                model.loss, params, batch, has_aux=True,
                phases=(tel.span("train.forward"),
                        tel.span("train.backward").anchor()))

    def train_step(params, opt_state, batch):
        with tel.span("train.step", step=next(calls)):
            return _step(params, opt_state, batch)

    def _step(params, opt_state, batch):
        if accum_steps == 1:
            (loss, aux), grads = grad_fn(params, batch)
        else:
            micro = _tree.tree_map(
                lambda x: x.reshape((accum_steps, x.shape[0] // accum_steps)
                                    + tuple(x.shape[1:])), batch)
            dev = _tree.leaves(params)[0].device
            g_sum = _tree.tree_map(
                lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), params)
            l_sum = torch.zeros((), device=dev)
            lb_sum = torch.zeros((), device=dev)
            for i in range(accum_steps):
                (l, aux), g = grad_fn(params, _tree.tree_map(
                    lambda x: x[i], micro))
                with tel.span("train.accumulate"):
                    g_sum = _add_trees(g_sum, g)
                    l_sum = l_sum + l
                    lb_sum = lb_sum + aux.get("load_balance", 0.0)
            with tel.span("train.accumulate"):
                grads = _tree.tree_map(lambda g: g / accum_steps, g_sum)
                loss = l_sum / accum_steps
                aux = {"ce": loss, "load_balance": lb_sum / accum_steps}
        if shardings is not None:
            mesh, p_spec, m_spec = shardings
            with tel.span("train.redistribute"):
                grads = sharding.redistribute(grads, m_spec, mesh)
        with tel.span("train.optimizer"):
            params, opt_state, gnorm = adamw_update(params, grads, opt_state,
                                                    opt_cfg)
        metrics = {"loss": loss, "gnorm": gnorm,
                   "ce": aux.get("ce", loss),
                   "load_balance": aux.get("load_balance",
                                           torch.zeros((), device=loss.device))}
        if shardings is not None:
            with tel.span("train.redistribute"):
                params = sharding.redistribute(params, p_spec, mesh)
                opt_state = dict(opt_state,
                                 m=sharding.redistribute(opt_state["m"],
                                                         m_spec, mesh),
                                 v=sharding.redistribute(opt_state["v"],
                                                         m_spec, mesh))
                metrics = {k: sharding.full(v) for k, v in metrics.items()}
        return params, opt_state, metrics

    return train_step


def _add_trees(a, b):
    flat, tdef = _tree.flatten(a)
    return tdef.unflatten(x + y for x, y in zip(flat, tdef.flatten_up_to(b)))


def make_prefill_step(model: Transformer, act_rules: dict | None = None):
    rules = act_rules or {}

    @torch.no_grad()
    def prefill_step(params, batch):
        with activation_sharding(rules):
            logits, _ = model.prefill(params, batch["tokens"],
                                      frames=batch.get("frames"),
                                      mrope_pos=batch.get("mrope_pos"))
        return logits

    return prefill_step


def make_serve_step(model: Transformer, act_rules: dict | None = None,
                    with_enc: bool = False):
    rules = act_rules or {}

    if with_enc:
        @torch.no_grad()
        def serve_step(params, caches, token, pos_idx, enc_kvs):
            with activation_sharding(rules):
                logits, caches = model.decode_step(params, token, caches,
                                                   pos_idx, enc_kvs=enc_kvs)
            return logits, caches
    else:
        @torch.no_grad()
        def serve_step(params, caches, token, pos_idx):
            with activation_sharding(rules):
                logits, caches = model.decode_step(params, token, caches,
                                                   pos_idx)
            return logits, caches

    return serve_step


def batch_struct(cfg: ModelConfig, batch: int, seq: int) -> dict:
    """The train/prefill batch's (shape, dtype) per entry, no
    allocation (the reference's ShapeDtypeStructs)."""
    i32 = torch.int32
    out = {"tokens": ((batch, seq), i32),
           "labels": ((batch, seq), i32)}
    if cfg.is_encdec:
        out["frames"] = ((batch, cfg.encoder.n_frames, cfg.d_model),
                         dtype_of(cfg.dtype))
    if cfg.mrope_sections:
        out["mrope_pos"] = ((3, batch, seq), i32)
    return out
