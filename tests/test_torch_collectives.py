"""The port's gradient exchange and its mesh paths against the JAX
reference, on the CPU, across processes.

* ``compressed_allreduce`` over 8 gloo ranks (spawned, ``FileStore`` in
  ``tmp_path``: no TCP port under xdist) on ``tests/test_collectives.py``'s
  inputs equals the reference's on 8 host devices at atol 1e-6, the tiny
  leaf the exact mean at 1e-6.
* A 2-rank ``make_train_step(compress_pod=True)`` on a gemma2-2b smoke
  config equals the composition of the reference's pieces at
  ``GRAD_TOL``: per-rank ``jax.value_and_grad(LM.loss)`` on its half
  batch, ``compressed_allreduce`` under ``shard_map`` on 2 host devices,
  then ``AdamW.update``; each piece is held where it is well conditioned
  (the test's docstring).  The reference's own ``shard_map`` train step is
  not used: on jax 0.9 its 8-device launch path fails to compile
  (``tests/test_dryrun_path.py``).
* The grouped ``moe_ffn(local_dispatch=True)`` at G = 2 (a (2, 1)
  ``("data", "model")`` gloo mesh) equals the reference's under a
  2-device host mesh at the MoE tests' 1e-4.

The JAX side runs in subprocesses with ``--xla_force_host_platform_
device_count``, the port's in spawned process groups; they meet in npz
files.
"""
import pathlib
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("torch")

REPO = pathlib.Path(__file__).resolve().parents[1]
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)      # tests/test_torch_train.py
TOL = dict(rtol=1e-4, atol=1e-4)           # tests/test_torch_moe.py


def _run(script: str, tmp_path, name: str, env_extra=None):
    path = tmp_path / f"{name}.py"
    path.write_text(script)
    env = {"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin",
           "HOME": str(tmp_path), "JAX_PLATFORMS": "cpu",
           "OMP_NUM_THREADS": "1"}
    env.update(env_extra or {})
    r = subprocess.run([sys.executable, str(path), str(tmp_path)],
                       capture_output=True, text=True, timeout=300, env=env,
                       cwd=REPO)
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-4000:])
    return r.stdout


INPUTS = r'''
import numpy as np
rng = np.random.default_rng(0)
G = rng.normal(size=(8, 64, 32)).astype(np.float32)
TINY = rng.normal(size=(8, 4)).astype(np.float32)
'''

JAX_ALLREDUCE = r'''
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.sharding.collectives import compressed_allreduce
''' + INPUTS + r'''
mesh = jax.make_mesh((8,), ("pod",))

def f(g, tiny):
    out = compressed_allreduce({"g": g[0], "t": tiny[0]}, "pod")
    return out["g"], out["t"]

smap = jax.shard_map(f, mesh=mesh, in_specs=(P("pod"), P("pod")),
                     out_specs=(P(), P()), axis_names={"pod"},
                     check_vma=False)
cg, ct = jax.jit(smap)(jnp.asarray(G), jnp.asarray(TINY))
np.savez(os.path.join(sys.argv[1], "jax_allreduce.npz"), g=np.asarray(cg),
         t=np.asarray(ct))
'''

TORCH_ALLREDUCE = r'''
import os, sys
import numpy as np, torch, torch.distributed as dist
import torch.multiprocessing as mp
''' + INPUTS + r'''

def worker(rank, root):
    from repro_torch.sharding.collectives import compressed_allreduce
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(root, "store8"), 8), rank=rank, world_size=8)
    out = compressed_allreduce({"g": torch.from_numpy(G[rank]),
                                "t": torch.from_numpy(TINY[rank])})
    if rank == 0:
        np.savez(os.path.join(root, "torch_allreduce.npz"),
                 g=out["g"].numpy(), t=out["t"].numpy())
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    mp.start_processes(worker, args=(sys.argv[1],), nprocs=8,
                       start_method="spawn")
'''


def test_compressed_allreduce_8_gloo_ranks_matches_reference(tmp_path):
    _run(JAX_ALLREDUCE, tmp_path, "jax_allreduce")
    _run(TORCH_ALLREDUCE, tmp_path, "torch_allreduce")
    j = np.load(tmp_path / "jax_allreduce.npz")
    t = np.load(tmp_path / "torch_allreduce.npz")
    rng = np.random.default_rng(0)
    g = rng.normal(size=(8, 64, 32)).astype(np.float32)
    tiny = rng.normal(size=(8, 4)).astype(np.float32)
    np.testing.assert_allclose(t["g"], j["g"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(t["t"], tiny.mean(0), rtol=1e-6, atol=1e-6)
    # int8 absmax rounding: the mean is within amax/127 of the exact one
    assert np.abs(t["g"] - g.mean(0)).max() < np.abs(g).max() / 127.0


# ------------------------------------------- 2 ranks: train step and MoE
PAIR_INPUTS = r'''
import dataclasses
import numpy as np
from repro_torch.configs import ARCHS
CFG = ARCHS["gemma2-2b"].smoke
MOE = ARCHS["granite-moe-3b-a800m"].smoke
rng = np.random.default_rng(1)
TOKENS = rng.integers(0, CFG.vocab, size=(4, 16)).astype(np.int32)
LABELS = rng.integers(0, CFG.vocab, size=(4, 16)).astype(np.int32)
MOE_X = rng.normal(size=(2, 16, MOE.d_model)).astype(np.float32)
MOE_KW = dict(n_experts=MOE.moe.n_experts, top_k=MOE.moe.top_k,
              capacity_factor=1.25)
'''

JAX_PAIR = r'''
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.configs import ARCHS as JARCHS
from repro.launch.steps import moe_local_rules
from repro.models import LM
from repro.models import layers
from repro.optim import AdamW
from repro.sharding.collectives import compressed_allreduce
from repro.sharding.ctx import sharding_rules
''' + PAIR_INPUTS + r'''
root = sys.argv[1]
cfg = JARCHS["gemma2-2b"].smoke
model = LM(cfg)
params = model.init(jax.random.PRNGKey(0))
opt = AdamW(lr=1e-3)
state = opt.init(params)
losses, grads = [], []
for r in range(2):                      # each rank's half of the batch
    b = {"tokens": jnp.asarray(TOKENS[2 * r:2 * r + 2]),
         "labels": jnp.asarray(LABELS[2 * r:2 * r + 2])}
    l, g = jax.value_and_grad(lambda p: model.loss(p, b, remat=True))(params)
    losses.append(l)
    grads.append(g)
stacked = jax.tree.map(lambda *x: jnp.stack(x), *grads)
mesh = jax.make_mesh((2,), ("pod",))

def ex(g, l):
    out = compressed_allreduce({"g": jax.tree.map(lambda x: x[0], g),
                                "l": l[0]}, "pod")
    return out["l"], out["g"]

spec_g = jax.tree.map(lambda _: P("pod"), stacked)
smap = jax.shard_map(ex, mesh=mesh, in_specs=(spec_g, P("pod")),
                     out_specs=(P(), jax.tree.map(lambda _: P(), stacked)),
                     axis_names={"pod"}, check_vma=False)
loss, g = jax.jit(smap)(stacked, jnp.stack(losses))
new_p, new_s, om = opt.update(params, g, state)
np.savez(os.path.join(root, "jax_step.npz"), loss=np.asarray(loss),
         grad_norm=np.asarray(om["grad_norm"]),
         **{f"p{i}": np.asarray(x) for i, x in
            enumerate(jax.tree.leaves(new_p))},
         **{f"g{i}": np.asarray(x) for i, x in
            enumerate(jax.tree.leaves(g))},
         **{f"r{r}_{i}": np.asarray(x) for r in range(2) for i, x in
            enumerate(jax.tree.leaves(grads[r]))})
np.savez(os.path.join(root, "params0.npz"),
         **{f"p{i}": np.asarray(x) for i, x in
            enumerate(jax.tree.leaves(params))})

# grouped MoE: the reference's local dispatch on a 2-device host mesh
mcfg = JARCHS["granite-moe-3b-a800m"].smoke
mp_ = LM(mcfg).init(jax.random.PRNGKey(1))["blocks"][0]
bp = {k: mp_[k][0] for k in ("router", "wg", "wu", "wd")}
mesh2 = jax.make_mesh((2, 1), ("data", "model"),
                      axis_types=(jax.sharding.AxisType.Auto,) * 2)
with mesh2, sharding_rules(mesh2, moe_local_rules(mesh2)):
    out, probs = jax.jit(lambda x, p: layers.moe_ffn(
        x, p, local_dispatch=True, **MOE_KW))(jnp.asarray(MOE_X), bp)
np.savez(os.path.join(root, "jax_moe.npz"), out=np.asarray(out),
         probs=np.asarray(probs),
         **{k: np.asarray(v) for k, v in bp.items()})
'''

TORCH_PAIR = r'''
import os, sys
import numpy as np, torch, torch.distributed as dist
import torch.multiprocessing as mp
''' + PAIR_INPUTS + r'''

def worker(rank, root):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.core.ddpg import tree_leaves, tree_unflatten
    from repro_torch.launch.steps import make_train_step, moe_local_rules
    from repro_torch.models import LM, layers
    from repro_torch.optim import AdamW
    from repro_torch.sharding.collectives import compressed_allreduce
    from repro_torch.sharding.ctx import sharding_rules
    from repro_torch.train.loop import value_and_grad
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(root, "store2"), 2), rank=rank, world_size=2)
    model = LM(CFG)
    like = model.init(0, device="cpu")
    p0 = np.load(os.path.join(root, "params0.npz"))
    params = tree_unflatten(like, [torch.from_numpy(p0[f"p{i}"])
                                   for i in range(len(p0.files))])
    opt = AdamW(lr=1e-3)
    step = make_train_step(model, opt, lr=1e-3, compress_pod=True)
    batch = {"tokens": torch.from_numpy(TOKENS[2 * rank:2 * rank + 2]),
             "labels": torch.from_numpy(LABELS[2 * rank:2 * rank + 2])}
    new_p, _, m = step(params, opt.init(params), batch)
    # the step's pieces: this rank's gradient and the exchanged mean;
    # the exchange of the reference's per-rank gradients; AdamW on the
    # reference's exchanged gradient
    _, grads = value_and_grad(lambda p: model.loss(p, batch, remat=True),
                              params)
    g = compressed_allreduce({"g": grads})["g"]
    js = np.load(os.path.join(root, "jax_step.npz"))
    n = len(p0.files)
    np.savez(os.path.join(root, f"torch_grads{rank}.npz"),
             **{f"g{i}": t.detach().numpy()
                for i, t in enumerate(tree_leaves(grads))})
    xg = compressed_allreduce({"g": tree_unflatten(like, [
        torch.from_numpy(js[f"r{rank}_{i}"]) for i in range(n)])})["g"]
    jg = tree_unflatten(like, [torch.from_numpy(js[f"g{i}"])
                               for i in range(n)])
    b_p, _, _ = opt.update(params, jg, opt.init(params), lr=1e-3)

    # grouped MoE on a (2, 1) mesh: x sharded over data
    jm = np.load(os.path.join(root, "jax_moe.npz"))
    mesh = init_device_mesh("cpu", (2, 1), mesh_dim_names=("data", "model"))
    x = DTensor.from_local(torch.from_numpy(MOE_X[rank:rank + 1]), mesh,
                           [Shard(0), Replicate()])
    bp = {k: torch.from_numpy(jm[k]) for k in ("router", "wg", "wu", "wd")}
    with sharding_rules(mesh, moe_local_rules(mesh)):
        out, probs = layers.moe_ffn(x, bp, local_dispatch=True, **MOE_KW)
        out = out.full_tensor()
        probs = probs.full_tensor() if isinstance(probs, DTensor) else probs
    if rank == 0:
        np.savez(os.path.join(root, "torch_step.npz"), loss=m["loss"].numpy(),
                 grad_norm=m["grad_norm"].numpy(),
                 **{f"p{i}": t.detach().numpy()
                    for i, t in enumerate(tree_leaves(new_p))},
                 **{f"g{i}": t.detach().numpy()
                    for i, t in enumerate(tree_leaves(g))},
                 **{f"b{i}": t.detach().numpy()
                    for i, t in enumerate(tree_leaves(b_p))},
                 **{f"x{i}": t.detach().numpy()
                    for i, t in enumerate(tree_leaves(xg))})
        np.savez(os.path.join(root, "torch_moe.npz"), out=out.numpy(),
                 probs=probs.numpy())
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    mp.start_processes(worker, args=(sys.argv[1],), nprocs=2,
                       start_method="spawn")
'''


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    root = tmp_path_factory.mktemp("pair")
    _run(JAX_PAIR, root, "jax_pair")
    _run(TORCH_PAIR, root, "torch_pair")
    return root


def _codes(x):
    """The exchange's int8 codes of one rank's leaf (``_q8``), and x / scale
    before rounding."""
    x = x.astype(np.float32)
    amax = np.abs(x).max(-1, keepdims=True)
    u = x / np.where(amax > 0, amax / np.float32(127), np.float32(1))
    return np.clip(np.round(u), -127, 127), u


def test_compressed_train_step_2_ranks_matches_reference(pair):
    """The step is a composition of maps, two of them ill-conditioned at
    isolated elements, so each piece is held where it is well conditioned:

    (a) The exchanged mean gradient.  Each rank's local gradient and the
        port's exchange of the reference's per-rank gradients match at
        ``GRAD_TOL`` everywhere.  The port's own exchanged gradient matches
        at ``GRAD_TOL`` wherever every rank's int8 code equals the
        reference's.  A code can differ only at a rounding tie: ``round``
        jumps by one code (amax / 127, halved by the mean of 2 ranks) when
        fp32 noise moves x / scale across k + 0.5 (e.g. 0.49999958 in the
        reference and 0.50000167 in the port).  Each such element must lie
        within 1e-3 codes of a tie on both sides, differ by exactly one
        code, and differ in the mean by at most that code step; there are
        fewer than 0.1 % of each leaf.
    (b) ``AdamW.update`` on the reference's exchanged gradient matches the
        reference's new parameters at ``GRAD_TOL`` everywhere.
    (c) The end-to-end new parameters match at ``GRAD_TOL`` wherever the
        gradient difference that (a) measured, carried through the first
        AdamW step's derivative ``lr c eps / (c |g| + eps)^2`` (c the clip
        factor), stays within ``GRAD_TOL``'s allowance on the parameter.
        Where the exchanged gradient is near ``eps`` that derivative is
        ~1e4: in one run leaf ``p11`` (``blocks[1].wd``) ``[0, 125, 19]``
        had g ~ 7e-9, so a gradient difference of ~8e-10 (fp32 noise, far
        inside GRAD_TOL) moved the parameter by 2.74e-5, against an
        allowance of ~1.6e-5, on one machine and not on another.  The
        elements left out are counted and must be under 0.1 % of each
        leaf.  GRAD_TOL's own allowance on g (atol 1e-5) carried through
        the same derivative would leave out most of the tied embedding,
        whose gradients are ~1e-6: it is far above the gradient's fp32
        noise, so the carried allowance is the difference (a) measured.
    """
    j, t = np.load(pair / "jax_step.npz"), np.load(pair / "torch_step.npz")
    ranks = [np.load(pair / f"torch_grads{r}.npz") for r in range(2)]
    np.testing.assert_allclose(t["loss"], j["loss"], **GRAD_TOL)
    np.testing.assert_allclose(t["grad_norm"], j["grad_norm"], **GRAD_TOL)
    n = len([k for k in j.files if k.startswith("p")])
    assert n == len([k for k in t.files if k.startswith("p")])
    lr, eps = 1e-3, 1e-8
    rtol, atol = GRAD_TOL["rtol"], GRAD_TOL["atol"]
    clip = min(1.0, 1.0 / (float(j["grad_norm"]) + 1e-9))
    ties, left_out = {}, {}
    for i in range(n):
        gj, pj = j[f"g{i}"], j[f"p{i}"]
        gt = t[f"g{i}"]
        # (a)
        for r in range(2):
            np.testing.assert_allclose(ranks[r][f"g{i}"], j[f"r{r}_{i}"],
                                       err_msg=f"rank {r} g{i}", **GRAD_TOL)
        np.testing.assert_allclose(t[f"x{i}"], gj, err_msg=f"x{i}",
                                   **GRAD_TOL)
        if gj.ndim == 0 or gj.size < 256:        # exchanged uncompressed
            tied = np.zeros(gj.shape, bool)
        else:
            tied, step = np.zeros(gj.shape, bool), np.zeros(gj.shape)
            for r in range(2):
                qj, uj = _codes(j[f"r{r}_{i}"])
                qt, ut = _codes(ranks[r][f"g{i}"])
                f = qj != qt
                assert np.all(np.abs(qj - qt)[f] == 1), f"g{i} rank {r}"
                for u in (uj, ut):
                    assert np.all(np.abs(u - np.floor(u) - 0.5)[f] < 1e-3), \
                        f"g{i} rank {r}: a code differs away from a tie"
                amax = np.abs(j[f"r{r}_{i}"]).max(-1, keepdims=True)
                step = step + np.where(f, amax / 127 / 2, 0.0)
                tied |= f
            assert tied.sum() < 1e-3 * gj.size, f"g{i}: {tied.sum()} ties"
            assert np.all(np.abs(gt - gj)[tied] <= (
                atol + rtol * np.abs(gj) + 1.001 * step)[tied]), f"g{i}"
        ties[f"g{i}"] = int(tied.sum())
        np.testing.assert_allclose(gt[~tied], gj[~tied], err_msg=f"g{i}",
                                   **GRAD_TOL)
        # (b)
        np.testing.assert_allclose(t[f"b{i}"], pj, err_msg=f"b{i}",
                                   **GRAD_TOL)
        # (c)
        dg = np.abs(gt.astype(np.float64) - gj)
        gain = lr * clip * eps / (clip * np.abs(gj).astype(np.float64)
                                  + eps) ** 2
        held = dg * gain <= atol + rtol * np.abs(pj)
        left_out[f"p{i}"] = int((~held).sum())
        assert left_out[f"p{i}"] < 1e-3 * pj.size, (f"p{i}", left_out)
        np.testing.assert_allclose(t[f"p{i}"][held], pj[held],
                                   err_msg=f"p{i}", **GRAD_TOL)
    print("int8 ties", ties, "ill-conditioned parameters left out", left_out)


def test_grouped_moe_local_dispatch_matches_reference(pair):
    j, t = np.load(pair / "jax_moe.npz"), np.load(pair / "torch_moe.npz")
    np.testing.assert_allclose(t["probs"], j["probs"], **TOL)
    np.testing.assert_allclose(t["out"], j["out"], **TOL)
