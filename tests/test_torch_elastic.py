"""Elastic restore on the port against ``repro.launch.elastic`` and
``repro.checkpoint.checkpointer``.

``plan_rescale`` equals the reference's over a sweep of mesh shapes and
survivor counts (exact).  A JAX process of four host devices
(``--xla_force_host_platform_device_count=4``) saves the internlm2 smoke
weights sharded over a 2 x 2 ("data", "model") mesh with the reference's
``Checkpointer`` (each leaf's record a list of shards with their index
slices, bf16 matrices among them); the port restores them onto its
one-device mesh through ``elastic_restore`` **bitwise**, and so it does
the reference's records of one whole file (host arrays) and its own.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.launch import elastic as jelastic
from repro_torch import configs as tconfigs
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.launch import elastic
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models.params import init_params, logical_axes
from repro_torch.sharding.policy import make_rules

REPO = Path(__file__).resolve().parents[1]

_SAVE = textwrap.dedent("""
    import sys
    import jax, jax.numpy as jnp, numpy as np
    from repro import configs
    from repro.checkpoint.checkpointer import Checkpointer
    from repro.launch.elastic import build_mesh
    from repro.models.params import init_params, logical_axes
    from repro.sharding.policy import make_rules, params_pspecs
    out, sharded = sys.argv[1], sys.argv[2] == "sharded"
    cfg = configs.get_smoke("internlm2-1.8b")
    params = init_params(cfg, jax.random.key(7))
    # the matrices in bf16 (the serving weights), the rest float32
    params = jax.tree.map(
        lambda x: x.astype(jnp.bfloat16) if x.ndim >= 2 else x, params)
    if sharded:
        mesh = build_mesh({"data": 2, "model": 2})
        sh = params_pspecs(logical_axes(cfg), make_rules("tp"), mesh,
                           params)
        params = jax.tree.map(jax.device_put, params, sh)
    else:
        # host arrays: the records of one whole file, index None
        params = jax.tree.map(np.asarray, params)
    Checkpointer(out).save(3, params, extra={"who": "jax"})

    def bits(x):
        if x.dtype == jnp.bfloat16:
            x = jax.lax.bitcast_convert_type(x, jnp.uint16)
        return np.asarray(x)
    np.savez(out + "/want.npz", **{
        "__".join(str(p.key) for p in path): bits(x)
        for path, x in jax.tree_util.tree_flatten_with_path(params)[0]})
""")


def _jax_checkpoint(tmp_path, sharded: bool) -> Path:
    out = tmp_path / ("sharded" if sharded else "whole")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(REPO / "src"))
    subprocess.run([sys.executable, "-c", _SAVE, str(out),
                    "sharded" if sharded else "whole"], check=True,
                   env=env, cwd=REPO, timeout=600)
    return out


def _tree_like(manifest):
    """Meta tensors of each leaf's shape and dtype, nested by path."""
    tree = {}
    for key, rec in manifest["leaves"].items():
        node = tree
        *head, last = key.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = torch.empty(rec["shape"], device="meta",
                                 dtype=getattr(torch, rec["dtype"]))
    return tree


def _walk(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], path + (k,))
    else:
        yield "/".join(path), tree


def _bits(t: torch.Tensor) -> np.ndarray:
    return (t.view(torch.int16).numpy().view(np.uint16)
            if t.dtype == torch.bfloat16 else t.numpy())


def test_plan_rescale_equals_the_reference():
    shapes = [{"data": 1, "model": 1}, {"data": 16, "model": 16},
              {"data": 8, "model": 4}, {"pod": 2, "data": 16, "model": 16},
              {"pod": 4, "data": 8, "model": 2}, {"data": 3, "model": 1}]
    n = 0
    for shape in shapes:
        for survivors in range(shape["model"], 2 * 512 + 1, 7):
            got = elastic.plan_rescale(shape, survivors)
            want = jelastic.plan_rescale(shape, survivors)
            assert (got.old_shape, got.new_shape, got.note) == \
                (want.old_shape, want.new_shape, want.note)
            assert list(got.new_shape) == list(want.new_shape)
            n += 1
        with pytest.raises(AssertionError):
            elastic.plan_rescale(shape, shape["model"] - 1)
    assert n > 400


def test_build_mesh():
    mesh = elastic.build_mesh({"data": 1, "model": 1}, "cpu")
    assert mesh.device == torch.device("cpu")
    with pytest.raises(RuntimeError, match="needs 4 devices"):
        elastic.build_mesh({"data": 2, "model": 2}, "cpu")


@pytest.mark.parametrize("sharded", [True, False])
def test_restores_a_jax_checkpoint_bitwise(tmp_path, sharded):
    ck_dir = _jax_checkpoint(tmp_path, sharded)
    manifest = json.loads((ck_dir / "step_00000003" / "manifest.json")
                          .read_text())
    records = [r for rec in manifest["leaves"].values()
               for r in rec["shards"]]
    if sharded:
        # a 2 x 2 mesh: some leaves in four shards, each with its slices
        assert max(len(r["shards"]) for r in manifest["leaves"].values()) \
            == 4
        assert all(r["index"] is not None for r in records)
    else:
        assert all(r["index"] is None for r in records)
    want = np.load(ck_dir / "want.npz")
    cfg = tconfigs.get_smoke("internlm2-1.8b")
    mesh = elastic.build_mesh({"data": 1, "model": 1}, "cpu")
    restored, extra = elastic.elastic_restore(
        Checkpointer(ck_dir), _tree_like(manifest), make_rules("tp"),
        logical_axes(cfg), mesh)
    assert extra == {"who": "jax"}
    leaves = dict(_walk(restored))
    assert set(leaves) == set(manifest["leaves"])
    for key, t in leaves.items():
        assert t.device == torch.device("cpu")
        assert str(t.dtype) == f"torch.{manifest['leaves'][key]['dtype']}"
        np.testing.assert_array_equal(_bits(t),
                                      want[key.replace("/", "__")])


def test_elastic_cycle_on_the_port(tmp_path):
    """save -> plan_rescale -> build_mesh -> elastic_restore, the port's
    own records, bitwise; without shardings the restore is in place."""
    cfg = tconfigs.get_smoke("internlm2-1.8b")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    ck = Checkpointer(tmp_path)
    ck.save(10, params)
    plan = elastic.plan_rescale({"data": 1, "model": 1}, 1)
    mesh = elastic.build_mesh(plan.new_shape, "cpu")
    restored, _ = elastic.elastic_restore(ck, params, make_rules("tp"),
                                          logical_axes(cfg), mesh)
    for (k, a), (_, b) in zip(_walk(params.tree()), _walk(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b), k
    other = init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    ck.restore(other)
    for (k, a), (_, b) in zip(_walk(params.tree()), _walk(other.tree())):
        assert torch.equal(a, b), k


def test_restore_onto_a_production_mesh_raises(tmp_path):
    cfg = tconfigs.get_smoke("internlm2-1.8b")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    ck = Checkpointer(tmp_path)
    ck.save(1, params)
    with pytest.raises(RuntimeError, match="needs 256 devices"):
        elastic.elastic_restore(ck, params, make_rules("tp"),
                                logical_axes(cfg), make_production_mesh())
    assert make_host_mesh("cpu").size == 1
