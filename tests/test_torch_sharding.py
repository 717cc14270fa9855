"""The port's sharding rules (``repro_torch.sharding``) against the JAX
reference's, on the CPU.

For every arch at full size (the port's params on the meta device, the
reference's as ``ShapeDtypeStruct``s), every shape it runs and both
production meshes, ``launch.steps.shardings_for`` (param, optimizer,
batch and cache specs) must equal the reference's ``PartitionSpec``s
entry by entry (a reference spec padded with None to the tensor's rank).
Then the DTensor side: ``to_placements`` on tuple axes, ``constrain``
outside a mesh, and a checkpoint saved unsharded restored onto a 2-rank
gloo mesh (spawned processes, ``FileStore`` in ``tmp_path``) and back.
"""
import pathlib
import subprocess
import sys
import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.launch.specs import step_structs as jstep_structs  # noqa: E402
from repro.launch.steps import shardings_for as jshardings_for  # noqa: E402
from repro.models import shape_by_name as jshape_by_name  # noqa: E402
from repro.optim import AdamW as JAdamW  # noqa: E402
from repro.sharding import specs as jsh  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.launch.specs import step_structs  # noqa: E402
from repro_torch.launch.steps import shardings_for  # noqa: E402
from repro_torch.models.api import shape_by_name  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402
from repro_torch.sharding import ctx  # noqa: E402
from repro_torch.sharding import specs as sh  # noqa: E402

FAKE_MESH = types.SimpleNamespace(shape={"data": 16, "model": 16})
FAKE_MESH_POD = types.SimpleNamespace(shape={"pod": 2, "data": 16,
                                             "model": 16})
MESHES = {"single": FAKE_MESH, "multi": FAKE_MESH_POD}
SHAPES = ["train_4k", "decode_32k", "long_500k"]
REPO = pathlib.Path(__file__).resolve().parents[1]


def _ref_specs(tree):
    """path -> spec of a reference spec tree (None outputs skipped)."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))[0]
    out = {}
    for path, spec in flat:
        keys = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
        out["/".join(keys)] = tuple(spec)
    return out


def _port_specs(tree):
    """path -> spec of a port spec tree."""
    out = {}

    def walk(node, path):
        if sh.is_spec(node):
            out[path] = node
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}/{k}" if path else str(k))
        elif isinstance(node, (tuple, list)):
            for i, v in enumerate(node):
                walk(v, f"{path}/{i}" if path else str(i))
    walk(tree, "")
    return out


CELLS = [(arch, shape, mesh) for arch in sorted(ARCHS) for shape in SHAPES
         for mesh in MESHES if shape not in ARCHS[arch].skip_shapes]


@pytest.mark.parametrize("arch,shape_name,mesh_kind", CELLS)
def test_specs_match_reference(arch, shape_name, mesh_kind):
    """Param, optimizer (8-bit), batch and cache specs of the step, entry
    by entry: the granite odd-expert fallback (40 experts over 16) and
    jamba's EP sharding included."""
    mesh = MESHES[mesh_kind]
    shp, jshp = shape_by_name(shape_name), jshape_by_name(shape_name)
    cfg, jcfg = ARCHS[arch].config, JARCHS[arch].config
    structs = step_structs(ARCHS[arch], shp, AdamW(state_bits=8))
    jstructs = jstep_structs(JARCHS[arch], jshp, JAdamW(state_bits=8))
    ins, _ = shardings_for(structs, shp.mode, cfg, shp, mesh)
    jins, _ = jshardings_for(jstructs, jshp.mode, jcfg, jshp, mesh)
    n = 0
    for port, ref, sds in zip(ins, jins, jstructs):
        if ref is None:
            continue
        want = _ref_specs(ref)
        shapes = {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                           for k in p): leaf.shape
                  for p, leaf in jax.tree_util.tree_flatten_with_path(sds)[0]}
        got = _port_specs(port)
        assert set(got) == set(want)
        for path, spec in want.items():
            nd = len(shapes[path])
            assert got[path] == spec + (None,) * (nd - len(spec)), path
            n += 1
    assert n > 0
    params = _port_specs(ins[0])
    if arch == "granite-moe-3b-a800m":          # 40 experts: not /16
        assert params["blocks/0/wg"][1] is None
    if arch == "jamba-1.5-large-398b":          # 16 experts over data=16
        assert params["blocks/1/wg"] == (None, "data", None, "model")


def test_quant_serve_specs_match_reference():
    """The int8 store's ``{"q", "s"}`` leaves: q takes its weight's rule,
    s is replicated."""
    shp, jshp = shape_by_name("decode_32k"), jshape_by_name("decode_32k")
    for arch in ("internlm2-20b", "granite-moe-3b-a800m"):
        structs = step_structs(ARCHS[arch], shp, AdamW(), quant_serve=True)
        jstructs = jstep_structs(JARCHS[arch], jshp, JAdamW(),
                                 quant_serve=True)
        got = _port_specs(sh.param_specs(structs[0], FAKE_MESH,
                                         ARCHS[arch].config))
        want = _ref_specs(jsh.param_specs(jstructs[0], FAKE_MESH,
                                          JARCHS[arch].config))
        assert set(got) == set(want)
        for path, spec in want.items():
            assert got[path][:len(spec)] == spec
            assert all(e is None for e in got[path][len(spec):])


def test_to_placements_tuple_axes():
    from torch.distributed.tensor import Replicate, Shard
    mesh = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    assert sh.to_placements((("pod", "data"), None, "model"), mesh) == (
        Shard(0), Shard(0), Shard(2))
    assert sh.to_placements((None, ("data", "model")), mesh) == (
        Replicate(), Shard(1), Shard(1))
    assert sh.to_placements((None, None), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="order"):
        sh.to_placements((("model", "data"),), mesh)


def test_constrain_is_a_no_op_outside_a_mesh():
    x = torch.arange(6.0).reshape(2, 3)
    assert ctx.current_mesh() is None
    assert ctx.constrain(x, "hidden") is x
    assert ctx.unshard(x, [0]) is x and ctx.settle(x) is x
    with ctx.sharding_rules(types.SimpleNamespace(), {"hidden": ("data",)}):
        assert ctx.constrain(x, "hidden") is x      # a plain tensor
        assert ctx.constrain(x, "logits") is x      # a role without a spec
    assert ctx.current_mesh() is None


CKPT_SCRIPT = r'''
import os, sys
import torch, torch.distributed as dist, torch.multiprocessing as mp


def worker(rank, root):
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import ARCHS
    from repro_torch.models import LM
    from repro_torch.sharding import specs as sh
    from repro_torch.train import CheckpointManager
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(root, "store"), 2), rank=rank, world_size=2)
    mesh = init_device_mesh("cpu", (2, 1), mesh_dim_names=("data", "model"))
    cfg = ARCHS["gemma2-2b"].smoke
    full = LM(cfg).init(0, device="cpu")
    cm = CheckpointManager(os.path.join(root, "unsharded"))
    if rank == 0:
        cm.save(3, full)
    dist.barrier()
    place = sh.tree_placements(sh.param_specs(full, mesh, cfg), mesh)
    step, got, _ = cm.restore(full, shardings=place, mesh=mesh)
    assert step == 3
    n_sharded = 0
    for (p, a), (_, b) in zip(sh_items(full), sh_items(got)):
        assert tuple(b.placements) == tuple(sh.to_placements(
            sh.param_spec(p, tuple(a.shape), mesh, cfg), mesh)), p
        n_sharded += b.to_local().numel() < a.numel()
        assert torch.equal(b.full_tensor(), a), p
    assert n_sharded > 0
    # and back: the sharded tree saved (rank 0 writes), restored unsharded
    cm2 = CheckpointManager(os.path.join(root, "sharded"))
    cm2.save(4, got)
    dist.barrier()
    step, back, _ = cm2.restore(full, device="cpu")
    for (p, a), (_, b) in zip(sh_items(full), sh_items(back)):
        assert torch.equal(a, b), p
    dist.barrier()
    if rank == 0:
        print("OK", n_sharded, flush=True)
    dist.destroy_process_group()


def sh_items(tree):
    from repro_torch.train.checkpoint import tree_flatten_with_path, path_str
    return [(path_str(p), x) for p, x in tree_flatten_with_path(tree)]


if __name__ == "__main__":
    mp.start_processes(worker, args=(sys.argv[1],), nprocs=2,
                       start_method="spawn")
'''


def test_checkpoint_restores_onto_a_gloo_mesh_and_back(tmp_path):
    script = tmp_path / "ckpt_mesh.py"
    script.write_text(CKPT_SCRIPT)
    r = subprocess.run([sys.executable, str(script), str(tmp_path)],
                       capture_output=True, text=True, timeout=300,
                       env={"PYTHONPATH": str(REPO / "src"),
                            "PATH": "/usr/bin:/bin", "HOME": str(tmp_path),
                            "OMP_NUM_THREADS": "1"}, cwd=REPO)
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-3000:])
    assert "OK" in r.stdout


def test_kernel_wrappers_refuse_dtensors():
    """Every kernel wrapper refuses a DTensor with a TypeError naming A11
    (a sharded path hands the kernels its local shards)."""
    from torch.distributed.tensor import DTensor, Replicate
    from repro_torch.kernels import (attention, binary_matmul, fake_quant,
                                     packed_matmul, quant_matmul)
    from repro_torch.launch.dryrun import fake_world
    from repro_torch.launch.mesh import make_production_mesh
    with fake_world(256):
        mesh = make_production_mesh(device_type="cpu")

        def dt(t):
            return DTensor.from_local(t, mesh, [Replicate(), Replicate()],
                                      run_check=False)
        x, pos = torch.ones(1, 4, 2, 8), torch.zeros(1, 4, dtype=torch.int32)
        calls = [
            lambda: attention.flash_attention(dt(x), x, x, q_pos=pos,
                                              kv_pos=pos),
            lambda: attention.paged_prefill_attention(
                dt(x), x, x, pos, pos, q_pos=pos),
            lambda: quant_matmul.quant_matmul(
                dt(torch.ones(2, 8)), torch.ones(8, 4, dtype=torch.int8),
                torch.ones(4)),
            lambda: packed_matmul.packed_matmul(
                torch.ones(2, 8), dt(torch.ones(4, 4, dtype=torch.int8)),
                torch.ones(4), store_bits=4),
            lambda: fake_quant.fake_quant_channels(
                dt(torch.ones(2, 4)), torch.ones(4), torch.ones(4),
                torch.ones(4)),
            lambda: binary_matmul.binary_matmul(
                dt(torch.ones(2, 8)), torch.ones(1, 8, 4, dtype=torch.int8),
                torch.ones(1, 4)),
        ]
        for call in calls:
            with pytest.raises(TypeError, match="A11"):
                call()
