"""The port's collective consensus forms (repro_torch.core.consensus:
pmean_mix, pmean_shardmap, mix_uniform_constrained, ring_mix,
general_mix) on gloo process groups on the CPU, against the JAX package's
``shard_map`` forms on 4 forced host devices and against the port's
stacked ``mix_stacked``, on the same numpy inputs.

The JAX forms run in a subprocess (the forced device count must not leak
into other tests), one agent per device of a ("data", "model") = (4, 1)
host mesh.  The port's run in one spawned world of 4 gloo ranks (one agent
each), which also holds a 2-rank subgroup with 2 agents a rank for
``mix_uniform_constrained`` and a 1-D ``DeviceMesh`` dimension given as
the group.  Inputs: 4 agents of a (3, 5) leaf and a (7,) leaf, f32 and
bf16; W: the ring's 0.5·I + 0.25·(shift₊ + shift₋) and Metropolis weights
of a 4-node path.

A bf16 ``pmean`` aborts the XLA CPU compiler of the installed JAX
("Invalid binary instruction opcode copy"), so for bf16 the two pmean
forms of the JAX package run on the bf16 values in f32 and are rounded to
bf16 after: the port's arithmetic (an f32 sum, divided, cast back).

Tolerance: f32 1e-6 of the largest magnitude (sums of four terms in
another order); bf16 two ulps at the largest magnitude (2^-6 of it: one
rounding of a mix of four, from sums in other orders, can land a bf16 ulp
apart)."""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import consensus as C  # noqa: E402
from repro_torch.core import graph as G  # noqa: E402
from repro_torch.distributed import comm  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
A = 4
SHAPES = {"a": (3, 5), "b": (7,)}
DTYPES = ("float32", "bfloat16")
RING = 0.5 * np.eye(A) + 0.25 * (np.roll(np.eye(A), 1, 1)
                                 + np.roll(np.eye(A), -1, 1))
METRO = G.metropolis_weights(np.array([[0, 1, 0, 0], [1, 0, 1, 0],
                                       [0, 1, 0, 1], [0, 0, 1, 0]]))
FORMS = ("pmean_mix", "pmean_shardmap", "mix_uniform_constrained",
         "ring_mix", "general_mix_ring", "general_mix_metropolis")
WANT_W = {"pmean_mix": None, "pmean_shardmap": None,
          "mix_uniform_constrained": None, "ring_mix": RING,
          "general_mix_ring": RING, "general_mix_metropolis": METRO}


def inputs():
    """{dtype: {leaf: (A, ...) float32 array, bf16-exact for bf16}}."""
    rng = np.random.default_rng(0)
    out = {}
    for dt in DTYPES:
        x = {k: rng.normal(size=(A,) + s).astype(np.float32)
             for k, s in SHAPES.items()}
        if dt == "bfloat16":
            x = {k: torch.from_numpy(v).bfloat16().float().numpy()
                 for k, v in x.items()}
        out[dt] = x
    return out


JAX_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.core import consensus as C
    from repro.launch.mesh import make_host_mesh

    src, dst = sys.argv[1], sys.argv[2]
    W = dict(np.load(src + ".w.npz"))
    data = np.load(src)
    mesh = make_host_mesh(1)
    assert mesh.devices.shape == (4, 1)
    out = {}
    for dt in ("float32", "bfloat16"):
        x = {k.split("/")[1]: jnp.asarray(data[k]).astype(dt)
             for k in data.files if k.startswith(dt + "/")}
        spec = P("data")
        specs = {k: spec for k in x}
        x = jax.device_put(x, NamedSharding(mesh, spec))

        def mapped(f):
            return jax.shard_map(f, mesh=mesh, in_specs=(specs,),
                                 out_specs=specs, axis_names={"data"})(x)

        # a bf16 pmean aborts this XLA's CPU compiler ("Invalid binary
        # instruction opcode copy"): the pmean forms run on the bf16
        # values in f32, rounded to bf16 after
        xp = jax.tree.map(lambda v: v.astype(jnp.float32), x)
        back = lambda t: jax.tree.map(lambda v: v.astype(dt), t)
        res = {
            "pmean_mix": back(jax.shard_map(
                lambda t: C.pmean_mix(t, ("data",)), mesh=mesh,
                in_specs=(specs,), out_specs=specs,
                axis_names={"data"})(xp)),
            "pmean_shardmap": back(C.pmean_shardmap(xp, ("data",), mesh)),
            "mix_uniform_constrained": C.mix_uniform_constrained(
                x, specs, mesh),
            "ring_mix": mapped(lambda t: C.ring_mix(t, "data")),
            "general_mix_ring": mapped(
                lambda t: C.general_mix(t, W["ring"], "data")),
            "general_mix_metropolis": mapped(
                lambda t: C.general_mix(t, W["metro"], "data")),
        }
        for form, tree in res.items():
            for k, v in tree.items():
                assert v.dtype == jnp.dtype(dt), (form, v.dtype)
                out[f"{dt}/{form}/{k}"] = np.asarray(v.astype(jnp.float32))
    np.savez(dst, **out)
""")


@pytest.fixture(scope="module")
def jax_forms(tmp_path_factory):
    d = tmp_path_factory.mktemp("jax_forms")
    src, dst = str(d / "in.npz"), str(d / "out.npz")
    np.savez(src, **{f"{dt}/{k}": v for dt, x in inputs().items()
                     for k, v in x.items()})
    np.savez(src + ".w.npz", ring=RING, metro=METRO)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    res = subprocess.run([sys.executable, "-c", JAX_SCRIPT, src, dst],
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return dict(np.load(dst))


def _rank_forms(rank, world, out_dir):
    """Every form on this rank's agent (and, on ranks 0-1, the 2-agent
    slices of a 2-rank subgroup); results to out_dir/rank<r>.json."""
    from torch.distributed.device_mesh import init_device_mesh

    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
    pair = torch.distributed.new_group([0, 1])
    res = {}
    for dt, x in inputs().items():
        tdt = getattr(torch, dt)
        mine = {k: torch.from_numpy(v[rank:rank + 1]).to(tdt)
                for k, v in x.items()}
        forms = {
            "pmean_mix": C.pmean_mix(mine),
            "pmean_shardmap": C.pmean_shardmap(mine, None),
            "mix_uniform_constrained": C.mix_uniform_constrained(mine),
            "ring_mix": C.ring_mix(mine, None),
            "general_mix_ring": C.general_mix(mine, RING),
            "general_mix_metropolis": C.general_mix(mine, METRO, None),
            "pmean_mix_mesh_dim": C.pmean_mix(mine, (mesh, "data")),
        }
        if rank < 2:
            two = {k: torch.from_numpy(v[2 * rank:2 * rank + 2]).to(tdt)
                   for k, v in x.items()}
            forms["mix_uniform_constrained_2x2"] = \
                C.mix_uniform_constrained(two, pair)
        for form, tree in forms.items():
            for k, v in tree.items():
                assert v.dtype == tdt, (form, v.dtype)
                res[f"{dt}/{form}/{k}"] = v.float().tolist()
    res["counts"] = comm.COUNTS
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


@pytest.fixture(scope="module")
def port_forms(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("port_forms"))
    comm.spawn(_rank_forms, A, d, store_dir=d, threads=1)
    ranks = []
    for r in range(A):
        with open(os.path.join(d, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    return ranks


def tol(dt, ref):
    scale = float(np.abs(ref).max())
    return (1e-6 if dt == "float32" else 2.0 ** -6) * max(scale, 1.0)


def stacked(form, dt, name):
    """The port's mix_stacked of the whole stack, leaf ``name``."""
    x = {k: torch.from_numpy(v).to(getattr(torch, dt))
         for k, v in inputs()[dt].items()}
    W = WANT_W[form]
    out = C.mix_stacked(x, np.full((A, A), 1.0 / A) if W is None else W)
    return out[name].float().numpy()


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("form", FORMS)
def test_collective_form_equals_jax_and_mix_stacked(form, dt, jax_forms,
                                                    port_forms):
    for name in SHAPES:
        got = np.concatenate([np.asarray(r[f"{dt}/{form}/{name}"],
                                         np.float32) for r in port_forms])
        ref = jax_forms[f"{dt}/{form}/{name}"]
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=0, atol=tol(dt, ref))
        want = stacked(form, dt, name)
        np.testing.assert_allclose(got, want, rtol=0, atol=tol(dt, want))
        # the mixing did something: no form returns its input
        x = inputs()[dt][name]
        assert np.abs(got - x).max() > 10 * tol(dt, want)


@pytest.mark.parametrize("dt", DTYPES)
def test_uniform_constrained_at_two_ranks_of_two_agents(dt, port_forms):
    """2 ranks x 2 agents (a subgroup of the 4-rank world): the global
    mean of all four agents, broadcast into each rank's pair; and the mean
    over a DeviceMesh dimension given as the group."""
    for name in SHAPES:
        got = np.concatenate([np.asarray(
            r[f"{dt}/mix_uniform_constrained_2x2/{name}"], np.float32)
            for r in port_forms[:2]])
        want = stacked("pmean_mix", dt, name)
        np.testing.assert_allclose(got, want, rtol=0, atol=tol(dt, want))
        got = np.concatenate([np.asarray(
            r[f"{dt}/pmean_mix_mesh_dim/{name}"], np.float32)
            for r in port_forms])
        np.testing.assert_allclose(got, want, rtol=0, atol=tol(dt, want))


def test_collectives_are_counted(port_forms):
    """The counts that the card's phase reads: calls and bytes per op, on
    CPU tensors nothing staged through host memory."""
    c = port_forms[1]["counts"]
    assert c["send_recv"]["calls"] == 2 * 2 * len(SHAPES)   # fwd + bwd
    assert c["all_gather"]["calls"] == 2 * 2 * len(SHAPES)
    # two pmeans, two uniform-constrained mixes, the mesh dimension's
    assert c["all_reduce"]["calls"] == 2 * 5 * len(SHAPES)
    assert all(v["staged"] == 0 for v in c.values())
    # f32 sums of a 15- and a 7-element leaf, both dtypes, five forms
    assert c["all_reduce"]["bytes"] == 2 * 5 * 4 * (15 + 7)
