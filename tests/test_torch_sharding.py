"""The port's sharding rules and meshes against ``repro.sharding.policy``
and ``repro.launch.mesh``.

The rule tables must be the reference's, key for key, for every
strategy, ``multi_pod`` and ``decode``; ``logical_to_pspec`` must give
the reference's ``PartitionSpec`` (compared as tuples: exact) on the 16 x
16 and 2 x 16 x 16 shape-only meshes, for every leaf of every config's
``logical_axes`` (whose names must equal the reference's) and every
strategy, and in the reference's own unit cases
(``tests/test_sharding_roofline.py``).  ``constrain`` is the identity
outside ``use_rules`` and on a mesh of one device, and a mesh of more
raises; so does placing a tensor on a production mesh.
"""
import jax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import configs as jconfigs
from repro.models.params import abstract_params as jabstract
from repro.models.params import logical_axes as jlogical
from repro.sharding import policy as jpolicy
from repro_torch import configs as tconfigs
from repro_torch.launch import mesh as tmesh
from repro_torch.models.params import abstract_params, logical_axes
from repro_torch.sharding import policy as tpolicy

STRATEGIES = ("tp", "cp", "tp_sp", "replicated")


class FakeMesh:
    """The reference's shape-only mesh for its pspec tests."""

    def __init__(self, shape):
        self.shape = shape


MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}


def _walk(tree, path=()):
    """(path, leaf) of a nested dict, keys sorted; a tuple is a leaf."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], path + (k,))
    else:
        yield path, tree


def _jax_leaves(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, tuple))[0]:
        out[tuple(p.key for p in path)] = leaf
    return out


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_rule_tables_equal_the_reference(strategy):
    for multi in (False, True):
        for decode in (False, True):
            want = jpolicy.make_rules(strategy, multi_pod=multi,
                                      decode=decode)
            got = tpolicy.make_rules(strategy, multi_pod=multi,
                                     decode=decode)
            assert got == want, (strategy, multi, decode)
            assert list(got) == list(want)


def test_unknown_strategy_raises_as_the_reference():
    with pytest.raises(ValueError, match="unknown strategy"):
        tpolicy.make_rules("zigzag")
    with pytest.raises(ValueError, match="unknown strategy"):
        jpolicy.make_rules("zigzag")


def test_logical_axes_equal_the_reference():
    """Every leaf's logical names and abstract shape, every config."""
    for arch in tconfigs.ALIASES:
        want = _jax_leaves(jlogical(jconfigs.get(arch)))
        got = dict(_walk(logical_axes(tconfigs.get(arch))))
        assert got == want, arch
        shapes = {k: tuple(v.shape) for k, v in _walk(
            abstract_params(tconfigs.get(arch)).tree())}
        jshapes = {k: tuple(v.shape) for k, v in _jax_leaves(
            jabstract(jconfigs.get(arch))).items()}
        assert shapes == jshapes, arch


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_pspecs_equal_the_reference_for_every_leaf(mesh_name):
    """Each weight's spec on a shape-only production mesh, for every
    config, strategy and decode flag, with and without its shape (the
    divisibility fallback)."""
    shape = MESHES[mesh_name]
    fake, mesh = FakeMesh(shape), tmesh.Mesh(shape)
    multi = "pod" in shape
    n = 0
    for arch in tconfigs.ALIASES:
        cfg = tconfigs.get(arch)
        axes = dict(_walk(logical_axes(cfg)))
        shapes = {k: tuple(v.shape)
                  for k, v in _walk(abstract_params(cfg).tree())}
        for strategy in STRATEGIES:
            for decode in (False, True):
                rules = tpolicy.make_rules(strategy, multi, decode)
                jrules = jpolicy.make_rules(strategy, multi, decode)
                for key, names in axes.items():
                    for s in (shapes[key], None):
                        got = tpolicy.logical_to_pspec(names, rules, mesh, s)
                        want = jpolicy.logical_to_pspec(names, jrules, fake,
                                                        s)
                        assert tuple(got) == tuple(want), (arch, key, s)
                        n += 1
    assert n > 1000


def test_params_pspecs_per_leaf():
    """``params_pspecs`` maps each leaf to ``logical_to_pspec`` of it."""
    cfg = tconfigs.get("phi3.5-moe-42b-a6.6b")
    mesh = tmesh.make_production_mesh()
    rules = tpolicy.make_rules("tp")
    shard = tpolicy.params_pspecs(logical_axes(cfg), rules, mesh,
                                  abstract_params(cfg))
    shapes = dict(_walk(abstract_params(cfg).tree()))
    for key, names in _walk(logical_axes(cfg)):
        sh = dict(_walk(shard))[key]
        assert sh.spec == tpolicy.logical_to_pspec(
            names, rules, mesh, shapes[key].shape)
        assert sh.mesh is mesh


def test_the_reference_unit_cases():
    """``tests/test_sharding_roofline.py:25-58`` on the port."""
    rules = tpolicy.make_rules("tp")
    mesh = tmesh.Mesh({"data": 16, "model": 16})
    assert tuple(tpolicy.logical_to_pspec(
        ("p_dmodel", "p_heads"), rules, mesh, (4096, 2048))) \
        == tuple(P("data", "model"))
    assert tuple(tpolicy.logical_to_pspec(
        ("act_batch", "act_kv_seq", "act_kv_heads", None), rules, mesh,
        (32, 1024, 4, 128))) == tuple(P("data"))
    drules = tpolicy.make_rules("tp", decode=True)
    assert tuple(tpolicy.logical_to_pspec(
        ("act_batch", "act_cache_seq", None, None), drules, mesh,
        (128, 32768, 8, 128))) == tuple(P("data", "model"))
    assert tuple(tpolicy.logical_to_pspec(
        ("act_batch", "act_cache_seq", None, None), drules, mesh,
        (1, 524288, 8, 128))) == tuple(P(None, ("data", "model")))
    tp, cp, sp = (tpolicy.make_rules(s) for s in ("tp", "cp", "tp_sp"))
    assert tp["act_heads"] == "model" and cp["act_heads"] is None
    assert cp["act_seq"] == "model"
    assert sp["act_res_seq"] == "model" and tp["act_res_seq"] is None


def test_axis_sizes_inputs_and_current_rules():
    mesh = tmesh.Mesh({"pod": 2, "data": 16, "model": 16})
    fake = FakeMesh(mesh.shape)
    for assignment in (None, "data", ("pod", "data"), ("data", "model"),
                       ("absent",)):
        assert tpolicy.axis_assignment_size(mesh, assignment) == \
            jpolicy.axis_assignment_size(fake, assignment)
    assert tpolicy.axis_assignment_size(None, "data") == 1
    rules = tpolicy.make_rules("tp", multi_pod=True)
    sh = tpolicy.input_sharding(mesh, rules, ("act_batch", "act_seq"),
                                (256, 4096))
    assert tuple(sh.spec) == tuple(jpolicy.logical_to_pspec(
        ("act_batch", "act_seq"), rules, fake, (256, 4096)))
    assert tpolicy.current_mesh_rules() == (None, None)
    with tpolicy.use_rules(rules, mesh):
        assert tpolicy.current_mesh_rules() == (mesh, rules)
    assert tpolicy.current_mesh_rules() == (None, None)


def test_constrain_is_the_identity_on_one_device():
    x = torch.randn(4, 8)
    names = ("act_batch", "act_dmodel")
    assert tpolicy.constrain(x, names) is x
    host = tmesh.make_host_mesh("cpu")
    with tpolicy.use_rules(tpolicy.make_rules("tp"), host):
        assert tpolicy.constrain(x, names) is x
    with tpolicy.use_rules(tpolicy.make_rules("tp"),
                           tmesh.make_production_mesh()):
        with pytest.raises(NotImplementedError, match="one device"):
            tpolicy.constrain(x, names)


def test_meshes():
    """Host mesh: one device, the reference's axes; production meshes:
    the reference's shapes and names, no devices, placement raises."""
    host = tmesh.make_host_mesh("cpu")
    assert host.shape == {"data": 1, "model": 1}
    assert host.device == torch.device("cpu")
    assert tmesh.mesh_name(host) == "1x1"
    for multi, name, n in ((False, "16x16", 256), (True, "2x16x16", 512)):
        mesh = tmesh.make_production_mesh(multi_pod=multi)
        assert tmesh.mesh_name(mesh) == name and mesh.size == n
        assert mesh.axis_names == (("pod", "data", "model") if multi
                                   else ("data", "model"))
        with pytest.raises(RuntimeError, match=f"needs {n} devices"):
            mesh.device
        sh = tpolicy.NamedSharding(mesh, tpolicy.PartitionSpec("data"))
        with pytest.raises(RuntimeError, match=f"needs {n} devices"):
            sh.device
