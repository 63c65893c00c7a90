"""The port's sharding rules against the JAX package, on the CPU.

The rule tables are plain data and must equal the reference's.
``filter_entry``/``filter_spec`` read only a mesh's name-to-size mapping,
so both packages get duck meshes (``.shape`` a dict) of any size,
the production 16x16 and 2x16x16 included, without 256 devices or ranks.
Logical and physical parameter specs are compared leaf by leaf on every
arch's tree, tiny and full: the port's from ``init_lm`` under a
``FakeTensorMode`` (shapes and dtypes, no storage), the reference's from
``jax.eval_shape``.  Everything here is exact.
"""
import ast
import dataclasses
import pathlib
import threading

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
from torch.distributed.tensor import Replicate, Shard

from repro import configs as jconfigs
from repro.models import init_lm as jinit_lm
from repro.sharding import api as japi
from repro.sharding import params as jparams
from repro_torch import configs as tconfigs
from repro_torch.launch import rules as trules
from repro_torch.models import init_lm as tinit_lm
from repro_torch.sharding import api as tapi
from repro_torch.sharding import params as tparams

ROOT = pathlib.Path(__file__).resolve().parent.parent
ARCHS = jconfigs.ARCHS
MESHES = {(1, 1): ("data", "model"), (2, 4): ("data", "model"),
          (16, 16): ("data", "model"), (2, 16, 16): ("pod", "data", "model")}


@dataclasses.dataclass
class DuckMesh:
    """What both packages read of a mesh: its axis sizes by name, and the
    port's placements also the dimension order."""
    shape: dict

    @property
    def mesh_dim_names(self):
        return tuple(self.shape)


def duck(shape, axes) -> DuckMesh:
    return DuckMesh(dict(zip(axes, shape)))


def _dryrun_tables() -> dict:
    """``ARCH_RULES`` and ``KIND_RULES`` of the reference's dry-run, read
    from its source: importing it sets ``XLA_FLAGS`` for the process."""
    tree = ast.parse((ROOT / "src/repro/launch/dryrun.py").read_text())
    out = {}
    for node in tree.body:
        if isinstance(node, ast.AnnAssign) and node.target.id in (
                "ARCH_RULES", "KIND_RULES"):
            out[node.target.id] = ast.literal_eval(node.value)
    return out


def ref_rules_for(arch: str, kind: str) -> japi.ShardingRules:
    """The reference's ``rules_for`` (launch/dryrun.py:60-66)."""
    tables = _dryrun_tables()
    table = dict(japi.DEFAULT_RULES)
    table.update(jparams.PARAM_LOGICAL_EXTRA)
    table.update(tables["ARCH_RULES"].get(arch, {}))
    table.update(tables["KIND_RULES"].get(kind, {}))
    return japi.ShardingRules(table)


def test_rule_tables_equal_the_reference():
    assert tapi.DEFAULT_RULES == japi.DEFAULT_RULES
    assert list(tapi.DEFAULT_RULES) == list(japi.DEFAULT_RULES)
    assert tparams._RULES == jparams._RULES
    assert tparams.PARAM_LOGICAL_EXTRA == jparams.PARAM_LOGICAL_EXTRA
    tables = _dryrun_tables()
    assert trules.ARCH_RULES == tables["ARCH_RULES"]
    assert trules.KIND_RULES == tables["KIND_RULES"]
    for arch in ARCHS:
        for kind in ("train", "prefill", "decode"):
            assert trules.rules_for(arch, kind).table == \
                ref_rules_for(arch, kind).table
    assert trules.rules_for("deepseek-7b", "train", {"seq": "model"}) \
        .table["seq"] == "model"


def test_rules_spec_and_replace():
    rules = tapi.default_rules(seq="model")
    spec = rules.spec("batch", "seq")
    assert isinstance(spec, tapi.PartitionSpec) and isinstance(spec, tuple)
    assert tuple(spec) == tuple(japi.default_rules(seq="model").spec(
        "batch", "seq")) == (("pod", "data"), "model")
    rules2 = rules.replace(seq=None)
    assert tuple(rules2.spec("batch", "seq")) == (("pod", "data"), None)
    assert tuple(rules.spec("batch", "seq")) == (("pod", "data"), "model")
    assert tuple(rules.spec(None, "unknown")) == (None, None)
    assert repr(tapi.P("data", None)) == "PartitionSpec('data', None)"


AXES = ("pod", "data", "model", "stage")
_sizes = st.sampled_from([1, 2, 3, 4, 16])
_meshes = st.dictionaries(st.sampled_from(AXES[:3]), _sizes, max_size=3)
_names = st.one_of(
    st.none(), st.sampled_from(AXES),
    st.lists(st.sampled_from(AXES), min_size=1, max_size=3,
             unique=True).map(tuple))


@settings(max_examples=80, deadline=None)
@given(mesh=_meshes, dim=st.integers(0, 64), names=_names,
       used=st.sets(st.sampled_from(AXES)))
def test_filter_entry_matches_the_reference(mesh, dim, names, used):
    ju, tu = set(used), set(used)
    want = japi.filter_entry(dim, names, DuckMesh(mesh), ju)
    assert tapi.filter_entry(dim, names, mesh, tu) == want
    assert tapi.filter_entry(dim, names, DuckMesh(mesh), None) == \
        japi.filter_entry(dim, names, DuckMesh(mesh), None)
    assert tu == ju


@settings(max_examples=60, deadline=None)
@given(mesh=_meshes,
       shape=st.lists(st.sampled_from([1, 2, 4, 6, 12, 16, 32, 48]),
                      min_size=0, max_size=4),
       spec=st.lists(_names, max_size=4))
def test_filter_spec_matches_the_reference(mesh, shape, spec):
    want = japi.filter_spec(tuple(shape), japi.P(*spec), DuckMesh(mesh))
    got = tapi.filter_spec(tuple(shape), tapi.P(*spec), mesh)
    assert isinstance(got, tapi.PartitionSpec)
    assert tuple(got) == tuple(want)


def _flat(tree, path=()):
    """{path: leaf} of the port's trees (dicts, lists; tuples are leaves)."""
    if isinstance(tree, dict):
        return {p: v for k, sub in tree.items()
                for p, v in _flat(sub, path + (k,)).items()}
    if isinstance(tree, list):
        return {p: v for i, sub in enumerate(tree)
                for p, v in _flat(sub, path + (i,)).items()}
    return {path: tree}


def _jflat(tree, leaf_type):
    """{path: leaf} of a reference pytree whose leaves are ``leaf_type``."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, leaf_type))[0]
    return {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path):
            leaf for path, leaf in flat}


def _trees(arch: str, size: str):
    get = {"tiny": (jconfigs.get_tiny, tconfigs.get_tiny),
           "full": (jconfigs.get_config, tconfigs.get_config)}[size]
    jshapes = jax.eval_shape(lambda: jinit_lm(jax.random.PRNGKey(0),
                                              get[0](arch)))
    with FakeTensorMode():
        tshapes = tinit_lm(torch.Generator("cpu"), get[1](arch),
                           device="cpu")
    return jshapes, tshapes


@pytest.mark.parametrize("size", ["tiny", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_the_reference(arch, size):
    jshapes, tshapes = _trees(arch, size)
    jleaves = _jflat(jshapes, jax.ShapeDtypeStruct)
    tleaves = _flat(tshapes)
    assert set(jleaves) == set(tleaves)
    assert all(tuple(tleaves[p].shape) == tuple(jleaves[p].shape)
               for p in jleaves)
    jlog = _jflat(jparams.logical_param_specs(jshapes), tuple)
    tlog = _flat(tparams.logical_param_specs(tshapes))
    assert tlog == jlog
    for kind in ("train", "decode"):
        jrules = ref_rules_for(arch, kind)
        trule = trules.rules_for(arch, kind)
        for shape, axes in MESHES.items():
            jphys = _jflat(jparams.physical_specs(
                jshapes, duck(shape, axes), jrules), japi.P)
            tphys = _flat(tparams.physical_specs(
                tshapes, dict(zip(axes, shape)), trule))
            assert all(isinstance(s, tapi.PartitionSpec)
                       for s in tphys.values())
            assert {p: tuple(s) for p, s in tphys.items()} == \
                {p: tuple(s) for p, s in jphys.items()}, (kind, shape)


@pytest.mark.parametrize("arch", ["grok-1-314b", "arctic-480b",
                                  "deepseek-7b"])
def test_param_shardings_follow_the_physical_specs(arch):
    """Each leaf's placements on a 2x16x16 mesh: ``Shard(d)`` on every
    mesh dimension its spec puts on tensor dim ``d``."""
    _, tshapes = _trees(arch, "full")
    mesh = duck((2, 16, 16), ("pod", "data", "model"))
    rules = trules.rules_for(arch, "train")
    specs = _flat(tparams.physical_specs(tshapes, mesh, rules))
    places = _flat(tparams.param_shardings(tshapes, mesh, rules))
    assert set(specs) == set(places)
    sharded = 0
    for path, spec in specs.items():
        want = [Replicate()] * 3
        for d, entry in enumerate(spec):
            for a in (() if entry is None else entry
                      if isinstance(entry, tuple) else (entry,)):
                want[mesh.mesh_dim_names.index(a)] = Shard(d)
        assert places[path] == tuple(want), path
        sharded += any(p != Replicate() for p in want)
    assert sharded > 0


@pytest.mark.parametrize("spec, want", [
    (tapi.P(), (Replicate(), Replicate(), Replicate())),
    (tapi.P(None, "model"), (Replicate(), Replicate(), Shard(1))),
    (tapi.P(("pod", "data"), None, "model"),
     (Shard(0), Shard(0), Shard(2))),
    (tapi.P("data", ("model",)), (Replicate(), Shard(0), Shard(1))),
    (tapi.P(None, None, ("data", "model")),
     (Replicate(), Shard(2), Shard(2))),
    (tapi.P(("pod", "data", "model")), (Shard(0), Shard(0), Shard(0))),
])
def test_to_placements(spec, want):
    mesh = duck((2, 4, 2), ("pod", "data", "model"))
    assert tapi.to_placements(spec, mesh) == want


def test_to_placements_leaves_size_one_dimensions_replicated():
    mesh = duck((1, 2), ("data", "model"))
    assert tapi.to_placements(tapi.P("data", "model"), mesh) == \
        (Replicate(), Shard(1))
    assert tapi.to_placements(tapi.P(("data", "model")), mesh) == \
        (Replicate(), Shard(0))


@pytest.mark.parametrize("spec", [tapi.P(("model", "data")),
                                  tapi.P("data", "data")])
def test_to_placements_rejects_what_shard_cannot_express(spec):
    with pytest.raises(ValueError):
        tapi.to_placements(spec, duck((2, 2), ("data", "model")))


def test_constrain_is_the_identity_outside_a_binding():
    x = torch.zeros((4, 4))
    assert tapi.constrain(x, "batch", "embed") is x
    assert tapi.current_binding() is None
    assert tapi.axis_size("heads") == 1
    # a plain tensor inside a binding is not placed either
    with tapi.use_mesh(duck((2, 2), ("data", "model"))):
        assert tapi.constrain(x, "batch", "embed") is x
        assert tapi.axis_size("heads") == 2
    with pytest.raises(RuntimeError):
        tapi.named_sharding("batch")


def test_use_mesh_nests_restores_and_is_per_thread():
    from torch.distributed.tensor import DTensor
    dispatcher = DTensor._op_dispatcher
    outer, inner = duck((2, 2), ("data", "model")), duck((4,), ("model",))
    rules = tapi.default_rules(seq="model")
    seen = {}

    def other_thread():
        seen["binding"] = tapi.current_binding()
        seen["implicit"] = dispatcher._allow_implicit_replication

    assert not dispatcher._allow_implicit_replication
    with tapi.use_mesh(outer, rules):
        assert tapi.current_binding() == (outer, rules)
        assert dispatcher._allow_implicit_replication
        with tapi.use_mesh(inner):
            mesh, r = tapi.current_binding()
            assert mesh is inner and r.table == tapi.DEFAULT_RULES
            assert tapi.axis_size("heads") == 4
            with tapi.use_mesh(None):
                assert tapi.current_binding() is None
                # left on by the outer mesh bindings
                assert dispatcher._allow_implicit_replication
            assert tapi.current_binding()[0] is inner
            assert dispatcher._allow_implicit_replication
        assert tapi.current_binding() == (outer, rules)
        assert dispatcher._allow_implicit_replication
        t = threading.Thread(target=other_thread)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
        assert seen["binding"] is None and not seen["implicit"]
    assert tapi.current_binding() is None
    assert not dispatcher._allow_implicit_replication


def test_named_sharding_drops_absent_axes():
    mesh = duck((2, 2), ("data", "model"))
    with tapi.use_mesh(mesh):
        got_mesh, placements = tapi.named_sharding("batch", "seq", "mlp")
    assert got_mesh is mesh
    assert placements == (Shard(0), Shard(2))


def test_replicated_is_the_function_outside_a_binding():
    def fn(a, n):
        return a * n, a + n
    x = torch.arange(4.0)
    assert tapi.replicated(fn) is not fn
    out = tapi.replicated(fn)(x, 3)
    assert torch.equal(out[0], x * 3) and torch.equal(out[1], x + 3)
    with tapi.use_mesh(duck((2,), ("data",))):   # no DTensor argument
        assert torch.equal(tapi.replicated(fn)(x, 2)[0], x * 2)


def test_fake_trees_hold_shapes_only():
    _, tree = _trees("deepseek-7b", "full")
    leaves = list(_flat(tree).values())
    assert all(isinstance(t, FakeTensor) for t in leaves)
    assert sum(int(np.prod(t.shape)) for t in leaves) > 6.9e9
