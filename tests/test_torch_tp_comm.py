"""The tensor-parallel collectives of ``repro_torch.distributed.comm``
(``copy_to_model``, ``reduce_from_model``, ``all_reduce_max``) on two gloo
ranks, and ``sharding.local_slice`` against JAX's
``NamedSharding(mesh, spec).devices_indices_map(shape)``.

* ``copy_to_model``: forward the identity, backward the gradient summed
  over the group (in f32, rounded once).
* ``reduce_from_model``: forward the sum over the group, in f32 and rounded
  once to the input's dtype (bf16 in, bf16 out), backward the identity.
* ``all_reduce_max``, ``layers.vocab_argmax`` with a tie across ranks (the
  lowest global index, as ``jnp.argmax``), and the counts by op, HLO kind
  and group.
* ``local_slice`` at every device of the (2, 2) and (1, 4) host meshes and
  of the 16x16 and 2x16x16 production meshes, for specs over one axis, two
  axes and none, equal to JAX's index map (a subprocess with 512 forced
  host devices).
* ``layers._MatmulF32Out``, the row-parallel product of bf16 operands
  with an f32 result (CUDA and meta only), on meta tensors: its dtypes
  and its gradients' shapes.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.distributed import comm  # noqa: E402
from repro_torch.distributed import sharding as SH  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "1x4": ((1, 4), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
#: (shape, spec) per mesh name; a spec entry is an axis, a list of axes
#: or None
CASES = {
    "2x2": [((8, 6), ["data", "model"]), ((8, 6, 4), [None, "model"]),
            ((12,), [["data", "model"]]), ((4, 4), [])],
    "1x4": [((8, 12), [None, "model"]), ((4, 8, 2), ["data", "model"])],
    "16x16": [((32, 64, 16), ["data", None, "model"]),
              ((256, 8), [["data", "model"]]), ((16, 16), ["model"])],
    "2x16x16": [((64, 32, 16), [["pod", "data"], "model"]),
                ((512, 4), [["pod", "data", "model"]]),
                ((4, 32), [None, "model"])],
}


def spec_of(entries):
    return SH.P(*(tuple(e) if isinstance(e, list) else e for e in entries))


JAX_SCRIPT = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    import numpy as np
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    meshes, cases = json.loads(sys.argv[1])
    out = {}
    for name, (shape, axes) in meshes.items():
        n = int(np.prod(shape))
        mesh = Mesh(np.array(jax.devices()[:n]).reshape(shape), tuple(axes))
        for i, (ashape, entries) in enumerate(cases[name]):
            spec = P(*(tuple(e) if isinstance(e, list) else e
                       for e in entries))
            imap = NamedSharding(mesh, spec).devices_indices_map(
                tuple(ashape))
            rows = []
            for pos in np.ndindex(*shape):
                idx = imap[mesh.devices[pos]]
                rows.append([list(pos), [[s.start or 0,
                                          s.stop if s.stop is not None
                                          else d]
                                         for s, d in zip(idx, ashape)]])
            out[f"{name}/{i}"] = rows
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def jax_maps():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    res = subprocess.run(
        [sys.executable, "-c", JAX_SCRIPT, json.dumps([MESHES, CASES])],
        env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("name", MESHES)
def test_local_slice_is_jax_devices_indices_map(jax_maps, name):
    shape, axes = MESHES[name]
    sizes = dict(zip(axes, shape))
    for i, (ashape, entries) in enumerate(CASES[name]):
        rows = jax_maps[f"{name}/{i}"]
        assert len(rows) == int(np.prod(shape))
        for pos, want in rows:
            got = SH.local_slice(ashape, spec_of(entries), sizes,
                                 dict(zip(axes, pos)))
            assert [[s.start, s.stop] for s in got] == want, (name, i, pos)


def test_local_slice_refuses_an_axis_that_does_not_divide():
    with pytest.raises(ValueError):
        SH.local_slice((6,), SH.P("model"), {"model": 4}, {"model": 1})


# ---------------------------------------------------------- collectives

def _rank_ops(rank, world, out_dir):
    from repro_torch.launch import mesh as ML
    from repro_torch.models import layers as L

    mesh = ML.make_host_mesh(world)                  # (1, 2)
    group = (mesh, "model")
    res = {}
    comm.reset_counts()
    # copy_to_model: identity forward, summed gradient backward
    x = torch.arange(4, dtype=torch.float32).requires_grad_(True)
    y = comm.copy_to_model(x, group)
    (y * (rank + 1.0)).sum().backward()
    res["copy_fwd"] = y.detach().tolist()
    res["copy_grad"] = x.grad.tolist()
    # reduce_from_model: an f32 sum rounded once, identity backward
    part = torch.tensor([1.0, 2.0 ** -8 * 0.75],
                        dtype=torch.bfloat16) if rank == 0 else \
        torch.tensor([2.0 ** -8 * 1.25, 1.0], dtype=torch.bfloat16)
    p = part.clone().requires_grad_(True)
    s = comm.reduce_from_model(p, group)
    (s.float() * torch.tensor([3.0, 5.0])).sum().backward()
    res["reduce_dtype"] = str(s.dtype)
    res["reduce_fwd"] = s.float().tolist()
    res["reduce_grad"] = p.grad.float().tolist()
    # all_reduce_max and the argmax with a tie on both ranks
    m = comm.all_reduce_max(torch.tensor([float(rank), -float(rank)]), group)
    res["max"] = m.tolist()
    with SH.use_rules(dict(SH.DEFAULT_RULES), mesh):
        logits = torch.tensor([[0.0, 5.0, 1.0], [2.0, 1.0, 0.0],
                               [0.0, 0.0, 0.0]]) if rank == 0 else \
            torch.tensor([[5.0, 0.0, 0.0], [1.0, 3.0, 3.0],
                          [0.0, 0.0, 0.0]])
        res["argmax"] = L.vocab_argmax(logits, 6).tolist()
    res["counts"] = {op: {k: c[k] for k in ("calls", "bytes")}
                     for op, c in comm.COUNTS.items()}
    res["hlo"] = comm.hlo_counts()
    res["groups"] = {g: {op: c["calls"] for op, c in ops.items()}
                     for g, ops in comm.GROUP_COUNTS.items()}
    with open(os.path.join(out_dir, f"ops{rank}.json"), "w") as f:
        json.dump(res, f)


@pytest.fixture(scope="module")
def ops(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tp_comm"))
    comm.spawn(_rank_ops, 2, d, store_dir=d, threads=1)
    out = []
    for r in range(2):
        with open(os.path.join(d, f"ops{r}.json")) as f:
            out.append(json.load(f))
    return out


def test_copy_to_model_sums_the_gradient(ops):
    for r in ops:
        assert r["copy_fwd"] == [0.0, 1.0, 2.0, 3.0]
        assert r["copy_grad"] == [3.0] * 4              # 1 + 2


def test_reduce_from_model_sums_in_f32_and_rounds_once(ops):
    # rank 0 + rank 1 in f32: [1 + 2^-8·1.25, 2^-8·0.75 + 1], each rounded
    # to bf16 once
    want = torch.tensor([1.0 + 2.0 ** -8 * 1.25, 1.0 + 2.0 ** -8 * 0.75]
                        ).bfloat16().float().tolist()
    for r in ops:
        assert r["reduce_dtype"] == "torch.bfloat16"
        assert r["reduce_fwd"] == want
        assert r["reduce_grad"] == [3.0, 5.0]          # identity backward


def test_max_and_the_vocab_split_argmax(ops):
    for r in ops:
        assert r["max"] == [1.0, 0.0]
        # row 0: 5 on rank 0 col 1 (1) and rank 1 col 0 (3): the lowest, 1;
        # row 1: 3 at global 4 and 5: 4; row 2: all equal: 0
        assert r["argmax"] == [1, 4, 0]


def test_counts_by_op_kind_and_group(ops):
    for r in ops:
        ar = r["counts"]["all_reduce"]
        # copy's backward, reduce's forward, the max, the argmax's two
        assert ar["calls"] == 5
        assert r["hlo"]["all-reduce"]["calls"] == 5
        assert set(r["hlo"]) == {"all-reduce"}
        assert r["groups"] == {"model": {"all_reduce": 5}}


def test_row_parallel_gemm_keeps_bf16_operands_and_an_f32_result():
    """``layers._MatmulF32Out`` (the row-parallel product off the CPU), on
    meta tensors: an f32 result from bf16 operands, bf16 gradients of the
    operands' shapes, and none asked for where none is needed."""
    from repro_torch.models import layers as L

    h = torch.empty((6, 4), dtype=torch.bfloat16, device="meta",
                    requires_grad=True)
    w = torch.empty((4, 3), dtype=torch.bfloat16, device="meta",
                    requires_grad=True)
    out = L._MatmulF32Out.apply(h, w)
    assert out.dtype == torch.float32 and out.shape == (6, 3)
    gh, gw = torch.autograd.grad(out.sum(), (h, w))
    assert (gh.dtype, gh.shape) == (torch.bfloat16, h.shape)
    assert (gw.dtype, gw.shape) == (torch.bfloat16, w.shape)
    frozen = w.detach()
    (gh2,) = torch.autograd.grad(L._MatmulF32Out.apply(h, frozen).sum(),
                                 (h,))
    assert gh2.shape == h.shape
