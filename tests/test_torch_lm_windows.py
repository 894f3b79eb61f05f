"""Decode past where a cache changes layout, on the port against the JAX
package, at the smoke configs' own dtype (bf16) and ``decode_both``'s
tolerance (0.05 * max|ref|):

* h2o-danube-3-4b's sliding window and recurrentgemma-9b's local window
  (16 positions each): 40 decode steps into a capacity of 48, so the
  ring of 16 slots wraps twice; the logits every step, the ring's
  positions and fill counter equal to the reference's, and the prefill
  over the 40 tokens;
* minicpm3-4b's MLA latent cache: 20 steps, past its ``attn_chunk`` of 8;
* whisper-base: the prefill over frames, then 12 cross-attention decode
  steps through ``make_serve_step(with_enc=True)``;
* qwen2-vl-2b's prefill with M-RoPE positions whose three axes differ (an
  image block between text).

The reference's weights carry across with ``params_from_numpy``; both
sides read the same tokens, frames and positions.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _lm_cases import B, scale
from repro.configs import get_config as jx_get_config
from repro.launch.steps import make_prefill_step as jx_make_prefill_step
from repro.launch.steps import make_serve_step as jx_make_serve_step
from repro.models import build as jx_build
from repro_torch.configs import get_config
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import build, params_from_numpy


def _models(arch: str):
    jm = jx_build(jx_get_config(arch, smoke=True))
    tm = build(get_config(arch, smoke=True))
    jp = jm.init(jax.random.key(0))
    return jm, jp, tm, params_from_numpy(jax.tree.map(np.asarray, jp),
                                         device="cpu")


def _close(got: torch.Tensor, ref, what: str) -> None:
    ref = np.asarray(ref, np.float32)
    got = got.float().numpy()
    assert np.isfinite(got).all(), what
    np.testing.assert_allclose(got, ref, rtol=0, atol=0.05 * scale(ref),
                               err_msg=what)


def _ring(tree, path: str = "") -> dict:
    """The caches' ``pos`` and ``idx`` leaves by their path."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {}
    out = {}
    for k, v in items:
        if k in ("pos", "idx"):
            out[f"{path}/{k}"] = v
        else:
            out.update(_ring(v, f"{path}/{k}"))
    return out


@pytest.mark.parametrize("arch, steps, capacity, wraps", [
    ("h2o-danube-3-4b", 40, 48, True),
    ("recurrentgemma-9b", 40, 48, True),
    ("minicpm3-4b", 20, 24, False)])
def test_decode_past_the_window_matches_reference(arch, steps, capacity,
                                                  wraps):
    jm, jp, tm, tp = _models(arch)
    cfg = tm.cfg
    edge = (cfg.window or cfg.local_window) if wraps else cfg.attn_chunk
    assert steps > 2 * edge if wraps else steps > edge
    tokens = np.random.default_rng(1).integers(
        0, cfg.vocab, (B, steps)).astype(np.int32)
    jc = jm.init_caches(B, capacity)
    tc = tm.init_caches(B, capacity, device="cpu")
    jstep = jax.jit(jm.decode_step)
    for i in range(steps):
        jl, jc = jstep(jp, jnp.asarray(tokens[:, i:i + 1]), jc, jnp.int32(i))
        with torch.no_grad():
            tl, tc = tm.decode_step(tp, torch.from_numpy(tokens[:, i:i + 1]),
                                    tc, i)
        _close(tl, jl, f"{arch} step {i}")
        want, got = _ring(jc), _ring(tc)
        assert want.keys() == got.keys() and want, arch
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                          err_msg=f"{arch} step {i} {k}")
    # the ring is the window's size, so it wrapped (the latent cache is
    # the capacity's)
    slots = {v.shape[-1] for k, v in _ring(tc).items() if k.endswith("pos")}
    assert slots == ({edge} if wraps else {capacity})
    jpf = jax.jit(jx_make_prefill_step(jm))
    with torch.no_grad():
        tl = make_prefill_step(tm)(tp, {"tokens": torch.from_numpy(tokens)})
    _close(tl, jpf(jp, {"tokens": jnp.asarray(tokens)}), f"{arch} prefill")


def test_whisper_prefill_and_cross_attention_decode_match_reference():
    jm, jp, tm, tp = _models("whisper-base")
    cfg = tm.cfg
    rng = np.random.default_rng(2)
    frames = np.asarray(jnp.asarray(rng.normal(size=(
        B, cfg.encoder.n_frames, cfg.d_model)), jnp.dtype(cfg.dtype)))
    steps = 12
    tokens = rng.integers(0, cfg.vocab, (B, steps)).astype(np.int32)
    jb = {"tokens": jnp.asarray(tokens), "frames": jnp.asarray(frames)}
    tb = {"tokens": torch.from_numpy(tokens),
          "frames": params_from_numpy(frames, device="cpu")}
    _close(make_prefill_step(tm)(tp, tb),
           jax.jit(jx_make_prefill_step(jm))(jp, jb), "whisper prefill")

    jenc = jm._cross_kvs(jp, jm.encode(jp, jb["frames"]))
    with torch.no_grad():
        tenc = tm._cross_kvs(tp, tm.encode(tp, tb["frames"]))
    jstep = jax.jit(jx_make_serve_step(jm, with_enc=True))
    tstep = make_serve_step(tm, with_enc=True)
    jc = jm.init_caches(B, 16)
    tc = tm.init_caches(B, 16, device="cpu")
    for i in range(steps):
        jl, jc = jstep(jp, jc, jnp.asarray(tokens[:, i:i + 1]), jnp.int32(i),
                       jenc)
        tl, tc = tstep(tp, tc, torch.from_numpy(tokens[:, i:i + 1]), i, tenc)
        _close(tl, jl, f"whisper decode step {i}")


def _image_positions(before: int, rows: int, cols: int, after: int):
    """M-RoPE positions [3, S]: text equal on the three axes, an image of
    ``rows`` x ``cols`` patches at one temporal position walking its rows
    (height) and columns (width), then text from one past its largest."""
    text = np.arange(before)
    img = [np.full(rows * cols, before),
           before + np.repeat(np.arange(rows), cols),
           before + np.tile(np.arange(cols), rows)]
    tail = before + max(rows, cols) + np.arange(after)
    return np.stack([np.concatenate([text, a, tail]) for a in img]
                    ).astype(np.int32)


def test_qwen2_vl_prefill_with_image_positions_matches_reference():
    jm, jp, tm, tp = _models("qwen2-vl-2b")
    pos = _image_positions(5, 2, 4, 5)
    assert (pos[0] != pos[1]).any() and (pos[1] != pos[2]).any()
    s = pos.shape[1]
    assert s > tm.cfg.attn_chunk
    tokens = np.random.default_rng(3).integers(
        0, tm.cfg.vocab, (B, s)).astype(np.int32)
    mpos = np.broadcast_to(pos[:, None], (3, B, s)).copy()
    jpf = jax.jit(jx_make_prefill_step(jm))
    ref = jpf(jp, {"tokens": jnp.asarray(tokens),
                   "mrope_pos": jnp.asarray(mpos)})
    got = make_prefill_step(tm)(tp, {"tokens": torch.from_numpy(tokens),
                                     "mrope_pos": torch.from_numpy(mpos)})
    _close(got, ref, "qwen2-vl image prefill")
    # the per-axis positions matter at this tolerance: the text-only ones
    # move the reference's logits by more than it
    text = np.broadcast_to(np.arange(s, dtype=np.int32)[None, None],
                           (3, B, s)).copy()
    moved = np.abs(np.asarray(jpf(jp, {"tokens": jnp.asarray(tokens),
                                        "mrope_pos": jnp.asarray(text)}),
                              np.float32) - np.asarray(ref, np.float32))
    assert moved.max() > 0.05 * scale(np.asarray(ref, np.float32))


def _chain_and_prefill(model, params, tokens, mrope, jax_side: bool):
    """(the teacher-forced decode chain's last logits, the prefill's) over
    ``tokens`` [1, S]."""
    s = tokens.shape[1]
    if jax_side:
        pre, _ = jax.jit(model.prefill)(params, jnp.asarray(tokens),
                                        mrope_pos=mrope)
        caches, step = model.init_caches(1, s), jax.jit(model.decode_step)
        for i in range(s):
            logits, caches = step(params, jnp.asarray(tokens[:, i:i + 1]),
                                  caches, jnp.int32(i))
        return np.asarray(logits, np.float32), np.asarray(pre, np.float32)
    with torch.no_grad():
        pre, _ = model.prefill(params, torch.from_numpy(tokens),
                               mrope_pos=mrope)
        caches = model.init_caches(1, s, device="cpu")
        for i in range(s):
            logits, caches = model.decode_step(
                params, torch.from_numpy(tokens[:, i:i + 1]), caches, i)
    return logits.float().numpy(), pre.float().numpy()


@pytest.mark.parametrize("arch", ["minicpm3-4b", "qwen2-vl-2b"])
def test_tied_head_prefill_against_decode_chain_at_depth(arch):
    """A head tied to the token table (drawn at scale 1) puts the logits
    near sqrt(d_model) times an untied head's. At the full config's depth
    (narrow widths) in bf16 the reference's own prefill and teacher-forced
    decode chain then part by more than 0.15 + 0.15 |ref|: the roundings
    of a deep stack, read at logits where bf16's spacing is 0.25-0.5. The
    port's prefill and chain stay within 0.05 * max|ref| of the
    reference's; on the same weights in float32 the port's prefill is
    within 0.15 + 0.15 |ref| of its chain (path L's check on the card)."""
    import dataclasses
    from repro_torch import _tree
    narrow = dict(d_model=512, n_heads=4, d_ff=1024, vocab=1024)
    jcfg = dataclasses.replace(jx_get_config(arch), **narrow)
    tcfg = dataclasses.replace(get_config(arch), **narrow)
    assert tcfg.tie_embeddings and tcfg.n_layers == get_config(arch).n_layers
    jm, tm = jx_build(jcfg), build(tcfg)
    jp = jm.init(jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    s = 16
    tokens = np.random.default_rng(4).integers(
        0, tcfg.vocab, (1, s)).astype(np.int32)
    text = np.broadcast_to(np.arange(s, dtype=np.int32)[None, None],
                           (3, 1, s)).copy() if tcfg.mrope_sections else None
    j_chain, j_pre = _chain_and_prefill(
        jm, jp, tokens, None if text is None else jnp.asarray(text), True)
    assert (np.abs(j_chain - j_pre) > 0.15 + 0.15 * np.abs(j_pre)).any()
    t_text = None if text is None else torch.from_numpy(text)
    t_chain, t_pre = _chain_and_prefill(tm, tp, tokens, t_text, False)
    for got, ref, what in ((t_pre, j_pre, "prefill"),
                           (t_chain, j_chain, "decode chain")):
        np.testing.assert_allclose(got, ref, rtol=0, atol=0.05 * scale(ref),
                                   err_msg=f"{arch} {what}")
    f32 = build(dataclasses.replace(tcfg, dtype="float32"))
    chain, pre = _chain_and_prefill(
        f32, _tree.tree_map(lambda t: t.float(), tp), tokens, t_text, False)
    np.testing.assert_allclose(chain, pre, rtol=0.15, atol=0.15)
