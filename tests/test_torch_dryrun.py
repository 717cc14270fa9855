"""The port's dry run (``launch/dryrun.py``) and roofline
(``launch/roofline.py``) against the JAX reference, on the CPU.

* ``count_params`` and ``model_flops`` equal the reference's exactly for
  every arch at full size.
* The per-device flops that :class:`DeviceCounter` (the
  ``torch.utils.flop_counter`` formulas) counts over a smoke train /
  prefill / decode step of gemma2-2b and granite-moe lie within 5 % of the
  reference's ``launch.hlo.analyze(...).flops`` on the same jitted step
  (they are equal at these shapes: both count every matmul, the
  rematerialized forward included, and nothing else).
* Under a 256-rank ``fake`` group one column-parallel linear counts 1/256
  of its global flops per device, and its weight all-gather's link bytes
  follow ``_ring_factor``.
* One reduced-depth cell (2 layers at full width; jamba one 8-layer
  period) runs end to end on the single and multi meshes for a dense arch,
  an MoE arch and the jamba hybrid; the CLIs write a cell and its
  roofline.
"""
import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.launch import roofline as jroofline  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.launch.hlo import analyze  # noqa: E402
from repro.launch.specs import step_structs as jstep_structs  # noqa: E402
from repro.models import LM as JLM  # noqa: E402
from repro.models.api import SHAPES as JSHAPES  # noqa: E402
from repro.models.api import ShapeCfg as JShapeCfg  # noqa: E402
from repro.optim import AdamW as JAdamW  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.launch import dryrun, roofline, steps  # noqa: E402
from repro_torch.launch.specs import step_structs  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.models.api import SHAPES, ShapeCfg  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_count_params_and_model_flops_match_reference(arch):
    got = roofline.count_params(ARCHS[arch].config)
    want = jroofline.count_params(JARCHS[arch].config)
    assert got == want
    for shp, jshp in zip(SHAPES, JSHAPES):
        assert roofline.model_flops(ARCHS[arch].config, shp, got) == \
            jroofline.model_flops(JARCHS[arch].config, jshp, want)


def _steps(model, opt, mode, pkg):
    if mode == "train":
        return pkg.make_train_step(model, opt)
    if mode == "prefill":
        return pkg.make_prefill_step(model)
    return pkg.make_decode_step(model)


@pytest.mark.parametrize("arch", ["gemma2-2b", "granite-moe-3b-a800m"])
@pytest.mark.parametrize("mode,name", [("train", "train_4k"),
                                       ("prefill", "prefill_32k"),
                                       ("decode", "decode_32k")])
def test_flop_count_matches_reference_hlo(arch, mode, name):
    jcfg, cfg = JARCHS[arch].smoke, ARCHS[arch].smoke
    jshape, shape = JShapeCfg(name, 32, 2, mode), ShapeCfg(name, 32, 2, mode)
    jstructs = jstep_structs(JARCHS[arch], jshape, JAdamW(state_bits=8),
                             cfg_override=jcfg)
    jstep = _steps(JLM(jcfg), JAdamW(state_bits=8), mode, jsteps)
    hlo = jax.jit(jstep).lower(*jstructs).compile().as_text()
    want = analyze(hlo, default_group=1).flops
    structs = step_structs(ARCHS[arch], shape, AdamW(state_bits=8),
                           cfg_override=cfg)
    got = dryrun.count_step(_steps(LM(cfg), AdamW(state_bits=8), mode,
                                   steps), structs)
    assert got["collectives"]["per_chip_bytes"] == 0.0
    assert abs(got["stats"]["flops_per_device"] - want) <= 0.05 * want


def test_column_parallel_linear_under_256_fake_ranks():
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models.layers import linear
    T, d, N = 4096, 256, 512
    with dryrun.fake_world(256):
        mesh = make_production_mesh(device_type="cpu")
        x = distribute_tensor(torch.empty(T, d, device="meta"), mesh,
                              [Shard(0), Replicate()])
        w = distribute_tensor(torch.empty(d, N, device="meta"), mesh,
                              [Shard(0), Shard(1)])      # (data, model)
        got = dryrun.count_step(lambda x, w: linear(x, w), (x, w), mesh,
                                {"w_col": (None, "model")})
    assert got["stats"]["flops_per_device"] == 2 * T * d * N / 256
    coll = got["collectives"]
    assert coll["op_counts"] == {"all-gather": 1}
    assert coll["comm_debug_counts"] == {"all_gather_into_tensor": 1}
    # the weight's FSDP shards gathered over "data": (d, N / 16) fp32
    gathered = d * (N // 16) * 4
    assert coll["per_chip_bytes"] == gathered * dryrun._ring_factor(
        "all-gather", 16)
    assert coll["per_axis_bytes"] == {"data": coll["per_chip_bytes"]}


CELLS = [("gemma2-2b", "train_4k"), ("granite-moe-3b-a800m", "train_4k"),
         ("jamba-1.5-large-398b", "decode_32k")]


@pytest.mark.parametrize("mesh_kind", ["single", "multi"])
@pytest.mark.parametrize("arch,shape", CELLS)
def test_reduced_depth_cell_runs(arch, shape, mesh_kind):
    r = dryrun.run_cell(arch, shape, mesh_kind, None, n_layers=2)
    assert r["status"] == "ok", r.get("traceback")
    assert r["devices"] == (512 if mesh_kind == "multi" else 256)
    assert r["n_layers"] == len(ARCHS[arch].config.pattern) * max(
        1, 2 // len(ARCHS[arch].config.pattern))
    st, coll = r["stats"], r["collectives"]
    assert st["flops_per_device"] > 0 and st["bytes_traffic_per_device"] > 0
    assert 0 < st["argument_bytes_per_device"]
    assert coll["per_chip_bytes"] > 0
    # the counter and CommDebugMode see the same collectives
    names = {"all-gather": "all_gather_into_tensor",
             "reduce-scatter": "reduce_scatter_tensor",
             "all-reduce": "all_reduce", "all-to-all": "all_to_all_single"}
    assert {names[k]: v for k, v in coll["op_counts"].items()} == \
        coll["comm_debug_counts"]
    if mesh_kind == "multi" and shape == "train_4k":
        assert coll["per_axis_bytes"]["pod"] > 0     # the pod exchange
    row = roofline.analyze_cell(r, dryrun.cut_depth(ARCHS[arch].config, 2),
                                dryrun.shape_by_name(shape))
    assert row["links"] == {a: "nic" for a in r["mesh_axes"]}
    assert 0 < row["useful_ratio"] <= 1.5


def test_dryrun_and_roofline_clis(tmp_path, capsys):
    out = tmp_path / "dryrun"
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "jamba-1.5-large-398b", "--shape",
                     "decode_32k", "--mesh", "both", "--layers", "2",
                     "--out", str(out)])
    assert e.value.code == 0
    cells = sorted(p.name for p in out.glob("*.json"))
    assert cells == ["jamba-1.5-large-398b__decode_32k__multi.json",
                     "jamba-1.5-large-398b__decode_32k__single.json"]
    roofline.main(["--dir", str(out), "--mesh", "single",
                   "--out", str(tmp_path / "roofline.json")])
    rows = json.loads((tmp_path / "roofline.json").read_text())
    assert len(rows) == 1 and rows[0]["dominant"] in (
        "compute", "memory", "collective")
    assert (tmp_path / "roofline.md").read_text().startswith("| arch |")
    assert roofline.axis_links({"data": 4, "model": 2}) == {
        "data": "nvlink", "model": "nvlink"}
    assert roofline.axis_links({"data": 16, "model": 8}) == {
        "data": "nic", "model": "nvlink"}
