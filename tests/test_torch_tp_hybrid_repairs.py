"""Two faults of the hybrid family under a model axis, each pinned against
the one-process run of the same numpy-seeded inputs.

recurrentgemma-9b's smoke config in f32 (one (rec, rec, attn) group and a
rec tail of 2; d_ff 256, a local window of 32), two gloo ranks on a
(data 1, model 2) mesh under ``serve_rules`` (the cache's slots over
"model"), each holding its local shards:

* The hybrid sub-layer's MLP must get ``cfg.d_ff``: without it
  ``layers.mlp`` takes its split hidden layer for a whole one and each
  rank keeps its partial sums of ``down``.  The forward's logits and one
  decode step's from an empty cache equal the one-process ones.
* The local-attention ring's length is the whole ring's, not the rank's
  span of its slots (``decode._cache_len``).  40 decode steps from an
  empty cache of 64 positions (a ring of 32 slots, 16 a rank: the steps
  pass the local half at 16 and wrap the ring at 32) equal the
  one-process steps.

Logits agree to rtol 1e-4 / atol 1e-5.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert as CV  # noqa: E402
from repro_torch.configs import registry as REG  # noqa: E402
from repro_torch.distributed import comm  # noqa: E402
from repro_torch.distributed import sharding as SH  # noqa: E402
from repro_torch.models import decode as D  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.training import train_step as TS  # noqa: E402

BATCH, PROMPT, STEPS, MAXLEN = 2, 24, 40, 64
TOL = dict(rtol=1e-4, atol=1e-5)


def inputs():
    """(f32 smoke config, seeded parameters, BATCH x STEPS tokens)."""
    cfg = REG.get_smoke_config("recurrentgemma-9b").replace(
        param_dtype="float32", compute_dtype="float32")
    params = T.init_params(torch.Generator().manual_seed(7), cfg, ())
    tokens = torch.as_tensor(np.random.default_rng(8).integers(
        0, cfg.vocab, size=(BATCH, STEPS)))
    return cfg, params, tokens


def units(params, cfg, tokens, mesh=None):
    """The forward's logits over the first PROMPT tokens, then STEPS
    decode steps' logits from an empty cache, each gathered whole."""
    rules = None if mesh is None else TS.serve_rules(cfg, False, BATCH, mesh)
    cache = D.init_cache(cfg, BATCH, MAXLEN)
    if mesh is not None:
        params = CV.shard_tree(params, TS.param_specs(params, rules, mesh,
                                                      False), mesh, "cpu")
        cache = CV.shard_tree(cache, TS.cache_specs(cache, rules, mesh),
                              mesh, "cpu")

    def whole(t):
        if mesh is None:
            return t
        spec = SH.P(*(None,) * (t.dim() - 1), "model")
        return SH.gather(t.contiguous(), spec, mesh,
                         tuple(t.shape[:-1]) + (cfg.vocab,))

    steps = []
    with torch.no_grad(), SH.use_rules(rules, mesh):
        fwd, _ = T.forward(params, {"tokens": tokens[:, :PROMPT]}, cfg)
        for t in range(STEPS):
            lg, cache = D.decode_step(params, cache, tokens[:, t:t + 1], t,
                                      cfg)
            steps.append(whole(lg[:, -1]))
        return whole(fwd).numpy(), torch.stack(steps).numpy()


def _rank(rank, world, d):
    from repro_torch.launch import mesh as ML

    cfg, params, tokens = inputs()
    fwd, dec = units(params, cfg, tokens, ML.make_host_mesh(2))
    if rank == 0:
        np.savez(os.path.join(d, "port.npz"), forward=fwd, decode=dec)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tp_hybrid"))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        comm.spawn(_rank, 2, d, store_dir=d, threads=1)
        cfg, params, tokens = inputs()
        want = units(params, cfg, tokens)
    finally:
        torch.set_num_threads(n)
    with np.load(os.path.join(d, "port.npz")) as z:
        return (z["forward"], z["decode"]), want


def test_hybrid_mlp_reduces_its_split_hidden_layer(runs):
    (fwd, dec), (want_fwd, want_dec) = runs
    np.testing.assert_allclose(fwd, want_fwd, **TOL)
    np.testing.assert_allclose(dec[0], want_dec[0], **TOL)


def test_hybrid_decode_rings_over_the_whole_window(runs):
    (_, dec), (_, want_dec) = runs
    np.testing.assert_allclose(dec, want_dec, **TOL)
