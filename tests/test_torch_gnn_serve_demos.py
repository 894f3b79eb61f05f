"""The streaming, bucketed and technology demos of
``repro_torch.examples.gnn_serve`` against the reference's demo functions
(``examples/gnn_serve.py``) at their own small sizes, on the CPU.

* ``--stream``: the same ticks (the reference's ``synthetic_stream``
  draw, handed to the port) from the reference server's parameters: the
  same commits and recompute fractions, the served embeddings within
  1e-4 * max|ref|.
* ``--buckets auto``: the printed layout (buckets, capacities, padded rows)
  equal to the reference's; overlapped equal to serialized and bucketed
  equal to dense, bit for bit (the reference's own verdict line says
  False for the latter on the CPU, where XLA rounds the two layouts'
  products differently, so it is not compared).
* ``--tech``: every printed line equal to the reference's (the technology
  table, the candidate count, the recommended plan and its tiers, the
  energy objective's flip) but the Monte-Carlo bound's, which draws its
  noise with another generator; the port's bound printed and finite.
"""
import importlib.util
import os

import jax
import numpy as np
import torch

from repro_torch.examples import gnn_serve

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reference():
    spec = importlib.util.spec_from_file_location(
        "reference_gnn_serve", os.path.join(ROOT, "examples",
                                            "gnn_serve.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _lines(text: str, drop: tuple = ()) -> list:
    return [ln for ln in text.splitlines()
            if ln.strip() and not any(d in ln for d in drop)]


def test_stream_demo_matches_reference(monkeypatch, capsys):
    import repro.streaming as jx_streaming
    import repro_torch.streaming as tr_streaming
    from repro.core import taxi as jx_taxi
    from repro_torch.core import taxi as tr_taxi

    made = []

    class Capture(jx_streaming.StreamingGNNServer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(jx_streaming, "StreamingGNNServer", Capture)
    ticks = 6
    _reference().stream_demo(ticks, 8)
    ref = made[0]
    stream = np.asarray(jx_taxi.synthetic_stream(
        jax.random.key(0), 300, ticks, jx_taxi.TaxiConfig(m=6, n=6)))
    params = [{k: torch.from_numpy(np.array(v)) for k, v in p.items()}
              for p in ref.params]

    class FromReference(tr_streaming.StreamingGNNServer):
        def __init__(self, plan, cfg, **kw):
            super().__init__(plan, cfg, params=params, **kw)

    # the port serves the reference's ticks from the reference's weights
    monkeypatch.setattr(tr_taxi, "synthetic_stream",
                        lambda *a, **kw: torch.from_numpy(stream.copy()))
    monkeypatch.setattr(tr_streaming, "StreamingGNNServer", FromReference)
    capsys.readouterr()
    srv = gnn_serve.stream_demo(ticks, 8, device="cpu")
    assert "commits" in capsys.readouterr().out
    assert (srv.commits, srv.full_refreshes) == (ref.commits,
                                                 ref.full_refreshes)
    assert [u.recompute_fraction for u in srv.updates] == \
        [u.recompute_fraction for u in ref.updates]
    scale = float(np.abs(ref.embeddings).max())
    np.testing.assert_allclose(srv.embeddings, ref.embeddings, rtol=0,
                               atol=1e-4 * scale)


def test_bucketed_demo_matches_reference(capsys):
    _reference().bucketed_demo(8, "auto", 0)
    drop = ("ms/forward", "bucketed == dense")
    ref = _lines(capsys.readouterr().out, drop=drop)
    outs = gnn_serve.bucketed_demo(8, "auto", 0, device="cpu")
    got = _lines(capsys.readouterr().out, drop=drop)
    assert got == ref
    assert np.array_equal(outs["overlap"], outs["serial"])
    assert np.array_equal(outs["overlap"], outs["dense"])


def test_tech_demo_matches_reference(capsys):
    _reference().tech_demo(8)
    ref = _lines(capsys.readouterr().out, drop=("MC accuracy bound",))
    picks = gnn_serve.tech_demo(8, device="cpu")
    out = capsys.readouterr().out
    assert _lines(out, drop=("MC accuracy bound",)) == ref
    assert "MC accuracy bound" in out
    assert np.isfinite(picks["bound"].mean_err)
    assert picks["head"] in picks["recommended"]


def test_cli_flags_run_the_demos(tmp_path, capsys):
    metrics, trace = tmp_path / "m.jsonl", tmp_path / "t.jsonl"
    srv = gnn_serve.main(["--stream", "3", "--device", "cpu", "--metrics",
                          str(metrics), "--trace", str(trace)])
    out = capsys.readouterr().out
    assert srv.commits >= 1 and "wrote" in out
    assert metrics.exists() and trace.exists()
