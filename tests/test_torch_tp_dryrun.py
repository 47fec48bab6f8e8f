"""The dry-run's collective record (``repro_torch.launch.dryrun``) and the
roofline's link term.

* The counts the dry-run takes on ``meta`` tensors in a ``fake`` world
  equal ``comm.COUNTS`` of the same units run for real on two gloo ranks
  at (1, 2): h2o-danube-1.8b's smoke config, a train step, a prefill and a
  decode step at small shapes; and one unit each of the vision, MLA, MoE,
  audio, SSM and hybrid families' smoke configs (``FAMILY_UNITS``).
* A production-mesh record of a dense (arch, shape) carries the JAX
  dry-run's keys (``collectives``: ``bytes_by_kind``, ``counts``,
  ``effective_bytes_per_device`` under its ring factors;
  ``extrapolated.collective_*``; ``analytic``), its depth extrapolation
  equals the full-depth count, and the roofline's link term is its
  effective bytes over NVLink's rate; a train record under the fsdp rule
  (recurrentgemma-9b's ``train_4k``) carries collectives (the layers'
  all-gathers over "data", their reduce-scatters, the all-reduces) whose
  extrapolation equals the full-depth count, and a link term.  One production record of
  each of the six families since the dense one (``FAMILY_RECORDS``)
  carries collectives whose extrapolation from 2 and 3 layers equals the
  full-depth count (whisper's from 2 and 3 layers of each of its two
  stacks, recurrentgemma's from 2 and 3 groups and its rec tail), and a
  link term.  These records are taken at one microbatch.
* A microbatched train record (``TRAIN_CONFIG``'s eight microbatches, as
  the JAX dry-run lowers its train records) extrapolates bilinear in
  depth and microbatches; at a smoke config on (data 2, model 1) it
  equals a direct count.
"""
import ast
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

from repro_torch.configs import registry as REG  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.distributed import comm  # noqa: E402
from repro_torch.experiments import roofline as RF  # noqa: E402
from repro_torch.launch import dryrun as DR  # noqa: E402
from repro_torch.launch import mesh as ML  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [InputShape("tiny_train", 16, 4, "train"),
          InputShape("tiny_prefill", 16, 2, "prefill"),
          InputShape("tiny_decode", 32, 2, "decode")]
#: one microbatch: a record's collectives are then a direct count at full
#: depth (the microbatched records' extrapolation is held against a direct
#: count by ``test_microbatched_record_equals_a_direct_count``)
TC = dataclasses.replace(DR.TRAIN_CONFIG, use_kernel=False, microbatches=1)
#: the fsdp smoke configs whose microbatched train record is counted
#: directly at trip count 4 on (data 2, model 1), at 8 rows a data rank
MB_ARCHS = ("qwen3-32b", "qwen3-moe-30b-a3b")
MB_SHAPE = InputShape("tiny_train", 16, 16, "train")


#: one unit of each family that runs tensor-parallel since the dense one:
#: arch -> the shape of SHAPES it runs at
FAMILY_UNITS = {"phi-3-vision-4.2b": "tiny_prefill",
                "minicpm3-4b": "tiny_train",
                "qwen3-moe-30b-a3b": "tiny_decode",
                "whisper-tiny": "tiny_train",
                "mamba2-780m": "tiny_train",
                "recurrentgemma-9b": "tiny_decode"}
#: one production record of each, at a shape whose rules put no fsdp axis
#: wider than 1 (whisper's prefill runs both of its stacks)
FAMILY_RECORDS = {"phi-3-vision-4.2b": "train_4k",
                  "minicpm3-4b": "decode_32k",
                  "qwen3-moe-30b-a3b": "prefill_32k",
                  "whisper-tiny": "prefill_32k", "mamba2-780m": "train_4k",
                  "recurrentgemma-9b": "decode_32k"}
#: a train record under the fsdp rule: its collectives include the
#: layers' gathers over "data" and their gradients' reduce-scatters
NULL_RECORD = ("recurrentgemma-9b", "train_4k")


def smoke(arch="h2o-danube-1.8b"):
    return REG.get_smoke_config(arch)


def family_counts(mesh, device="meta"):
    shapes = {s.name: s for s in SHAPES}
    return {arch: DR.count_collectives(smoke(arch), shapes[name], mesh,
                                       False, TC, device)
            for arch, name in FAMILY_UNITS.items()}


def _rank_counts(rank, world, out_dir):
    mesh = ML.make_host_mesh(2)
    got = {s.name: DR.count_collectives(smoke(), s, mesh, False, TC, "cpu")
           for s in SHAPES}
    fams = family_counts(mesh, "cpu")
    if rank == 0:
        with open(os.path.join(out_dir, "real.json"), "w") as f:
            json.dump(got, f)
        with open(os.path.join(out_dir, "families.json"), "w") as f:
            json.dump(fams, f)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def gloo_run(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tp_dryrun"))
    comm.spawn(_rank_counts, 2, d, store_dir=d, threads=1)
    return d


@pytest.fixture(scope="module")
def real(gloo_run):
    with open(os.path.join(gloo_run, "real.json")) as f:
        return json.load(f)


def test_meta_counts_equal_a_real_gloo_run(real):
    with ML.fake_world(2):
        mesh = ML.make_host_mesh(2)
        meta = {s.name: DR.count_collectives(smoke(), s, mesh, False, TC)
                for s in SHAPES}
    assert json.loads(json.dumps(meta)) == real
    for s in SHAPES:
        assert real[s.name]["counts"]["all-reduce"] > 0


@pytest.fixture(scope="module")
def family_meta():
    with ML.fake_world(2):
        return json.loads(json.dumps(family_counts(ML.make_host_mesh(2))))


@pytest.mark.parametrize("arch", FAMILY_UNITS)
def test_family_meta_counts_equal_a_real_gloo_run(gloo_run, family_meta,
                                                   arch):
    with open(os.path.join(gloo_run, "families.json")) as f:
        real = json.load(f)[arch]
    assert family_meta[arch] == real
    assert real["counts"]["all-reduce"] > 0
    if arch in ("minicpm3-4b", "mamba2-780m", "recurrentgemma-9b"):
        # MLA's latent and output, mamba2's projection and conv weight,
        # the RG-LRU gates' input: gathered
        assert real["counts"]["all-gather"] > 0


def jax_coll_factor():
    src = open(os.path.join(REPO, "src", "repro", "launch",
                            "dryrun.py")).read()
    for node in ast.walk(ast.parse(src)):
        if (isinstance(node, ast.Assign) and isinstance(node.targets[0],
                                                        ast.Name)
                and node.targets[0].id == "_COLL_FACTOR"):
            return ast.literal_eval(node.value)
    raise AssertionError("no _COLL_FACTOR")


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("tp_records"))
    recs = DR.run_mesh(["h2o-danube-1.8b"], ["decode_32k"], False, out, TC)
    recs += [r for arch, shape in (NULL_RECORD, *FAMILY_RECORDS.items())
             for r in DR.run_mesh([arch], [shape], False, out, TC)]
    return {(r["arch"], r["shape"]): r for r in recs}, out


def test_records_carry_the_jax_keys_and_the_link_term(records):
    recs, out = records
    assert DR.COLL_FACTOR == jax_coll_factor()
    r = recs[("h2o-danube-1.8b", "decode_32k")]
    coll = r["collectives"]
    assert set(coll) == {"bytes_by_kind", "counts",
                         "effective_bytes_per_device"}
    assert set(coll["counts"]) == {"all-reduce"}
    assert coll["effective_bytes_per_device"] == 2.0 * \
        coll["bytes_by_kind"]["all-reduce"] > 0
    ext = r["extrapolated"]
    assert ext["trip_count"] == 24
    # the per-layer collectives are affine in depth: the extrapolation from
    # 2 and 3 layers is the full-depth count
    assert ext["collective_bytes_by_kind"] == coll["bytes_by_kind"]
    assert ext["collective_effective_bytes_per_device"] == \
        coll["effective_bytes_per_device"]
    assert {"exec_flops", "model_flops", "hbm_bytes"} <= set(r["analytic"])
    t = RF.roofline_terms(r)
    assert t["t_link_s"] == ext["collective_effective_bytes_per_device"] \
        / 450e9 > 0
    assert RF.CHIPS["16x16"] == 256 and RF.CHIPS["2x16x16"] == 512
    m = recs[NULL_RECORD]
    mc = m["collectives"]
    assert "collectives_reason" not in m
    assert min(mc["counts"][k] for k in ("all-gather", "reduce-scatter",
                                         "all-reduce")) > 0
    assert m["extrapolated"]["collective_bytes_by_kind"] == \
        mc["bytes_by_kind"]
    tm = RF.roofline_terms(m)
    assert tm["t_link_s"] == m["extrapolated"][
        "collective_effective_bytes_per_device"] / 450e9 > 0
    text = RF.report(RF.load_records(out))
    assert text.startswith("Card: NVIDIA H100 80GB HBM3, 700.00 W")
    assert "NVLink" in text
    row = [l for l in text.splitlines()
           if l.startswith("| %s | %s | 16x16" % NULL_RECORD)]
    assert len(row) == 1 and "| n/a |" not in row[0]
    assert np.isfinite(t["step_time_bound_s"])


@pytest.mark.parametrize("arch", FAMILY_RECORDS)
def test_family_records_carry_collectives_and_extrapolate(records, arch):
    recs, _ = records
    r = recs[(arch, FAMILY_RECORDS[arch])]
    assert r["status"] == "ok"
    coll, ext = r["collectives"], r["extrapolated"]
    assert coll["counts"]["all-reduce"] > 0
    # per-layer collectives affine in depth, whisper's two stacks included
    assert ext["collective_bytes_by_kind"] == coll["bytes_by_kind"]
    assert RF.roofline_terms(r)["t_link_s"] > 0


@pytest.mark.parametrize("M", (4, 8))
@pytest.mark.parametrize("arch", MB_ARCHS)
def test_microbatched_record_equals_a_direct_count(arch, M):
    """A train record at M microbatches extrapolates its counts at trip
    counts 2 and 3 and at 2 and 4 microbatches bilinear in (L, M): at trip
    count 4 it equals a direct meta count of the step, call for call and
    byte for byte (the layers' gathers and reduce-scatters at every
    microbatch, MoE's routing counts, the rows' exchange once a step).
    The smoke MoE's capacity divides evenly at every M here; where its
    rounding does not, the record is off by the capacity's share (the
    dry-run module's docstring)."""
    cfg = REG.reduced_layers(smoke(arch), 4)
    tc = dataclasses.replace(TC, microbatches=M)
    with ML.fake_world(2):
        mesh = ML.make_host_mesh(1)                   # (data 2, model 1)
        rec = DR.collective_record(cfg, MB_SHAPE, mesh, False, tc)
        direct = DR.count_collectives(cfg, MB_SHAPE, mesh, False, tc)
        one = DR.count_collectives(cfg, MB_SHAPE, mesh, False, TC)
    assert rec["collectives"] == direct
    ext = rec["extrapolated"]
    assert (ext["trip_count"], ext["microbatches"]) == (4, M)
    assert ext["collective_bytes_by_kind"] == direct["bytes_by_kind"]
    # the layers' gathers repeat with each microbatch; one exchange a step
    assert direct["counts"]["all-gather"] > M * one["counts"]["all-gather"]
    assert direct["counts"]["reduce-scatter"] == \
        M * one["counts"]["reduce-scatter"]
