"""The port's dry-run against the JAX package's, on the CPU.

The roofline's arithmetic, its tables and the input stand-ins are held
against the reference exactly (``roofline_fraction`` scaled by the ratio
of the two data sheets' bf16 peaks).  The cost tracer and the traced
cells are in ``test_torch_dryrun_trace.py``.

The reference's ``dryrun.py`` and ``perf.py`` set ``XLA_FLAGS`` for 512
devices when imported, so their pieces are read by ``ast`` here, or run
in a subprocess.
"""
import ast
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st
from torch._subclasses.fake_tensor import FakeTensorMode

from repro import configs as jconfigs
from repro.launch import roofline as jroofline
from repro.launch import specs as jspecs
from repro.launch import tabulate as jtabulate
from repro.models import init_lm as jinit_lm
from repro.sharding import api as japi
from repro.sharding import params as jparams
from repro_torch import configs as tconfigs
from repro_torch.launch import dryrun as tdryrun
from repro_torch.launch import roofline as troofline
from repro_torch.launch import specs as tspecs
from repro_torch.launch import tabulate as ttabulate
from repro_torch.models import init_lm as tinit_lm
from repro_torch.sharding import params as tparams

ROOT = pathlib.Path(__file__).resolve().parent.parent
ARCHS = jconfigs.ARCHS
HLO = """
  %all-gather = bf16[64,1024]{1,0} all-gather(%p), replica_groups=[16,16]<=[256], dimensions={0}
  %all-reduce.1 = f32[128]{0} all-reduce(%x), replica_groups=[1,256]<=[256], to_apply=%add
  %fusion = f32[2,2] fusion(%all-reduce.1)
  %collective-permute = bf16[8,8]{1,0} collective-permute(%y), source_target_pairs={{0,1}}
  ROOT %t = (f32[4]{0}, f32[4]{0}) all-to-all(%a, %b), replica_groups=[64,4]<=[256]
"""


@dataclasses.dataclass
class DuckMesh:
    """What both packages read of a mesh: its axis sizes by name."""
    shape: dict

    @property
    def mesh_dim_names(self):
        return tuple(self.shape)


MESHES = {"single": DuckMesh({"data": 16, "model": 16}),
          "multi": DuckMesh({"pod": 2, "data": 16, "model": 16})}


def _ref_source() -> ast.Module:
    return ast.parse((ROOT / "src/repro/launch/dryrun.py").read_text())


def _ref_function(name: str, namespace: dict):
    """A function of the reference's dry-run, compiled from its source
    into ``namespace``."""
    tree = _ref_source()
    node = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == name)
    exec(compile(ast.Module([node], []), "dryrun.py", "exec"), namespace)
    return namespace[name]


def ref_rules_for(arch: str, kind: str) -> japi.ShardingRules:
    tables = {}
    for node in _ref_source().body:
        if isinstance(node, ast.AnnAssign) and node.target.id in (
                "ARCH_RULES", "KIND_RULES"):
            tables[node.target.id] = ast.literal_eval(node.value)
    table = dict(japi.DEFAULT_RULES)
    table.update(jparams.PARAM_LOGICAL_EXTRA)
    table.update(tables["ARCH_RULES"].get(arch, {}))
    table.update(tables["KIND_RULES"].get(kind, {}))
    return japi.ShardingRules(table)


def _jflat(tree, leaf_type):
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, leaf_type))[0]
    return {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path):
            leaf for path, leaf in flat}


def _tflat(tree, path=()):
    if isinstance(tree, dict):
        return {p: v for k, sub in tree.items()
                for p, v in _tflat(sub, path + (k,)).items()}
    if isinstance(tree, list):
        return {p: v for i, sub in enumerate(tree)
                for p, v in _tflat(sub, path + (i,)).items()}
    return {path: tree}


def _dtype(x) -> str:
    return str(x.dtype).replace("torch.", "")


# --------------------------------------------------------------------------
# roofline arithmetic
# --------------------------------------------------------------------------

def test_collective_bytes_equals_the_reference_hlo_parse():
    records = [("all-gather", 64 * 1024 * 2, 16),
               ("all-reduce", 128 * 4, 256),
               ("collective-permute", 8 * 8 * 2, 1),
               ("all-to-all", 2 * 4 * 4, 4)]
    assert troofline.collective_bytes(records) == \
        jroofline.collective_bytes(HLO)
    assert troofline.collective_bytes([]) == {"total": 0.0}
    assert troofline._DTYPE_BYTES == jroofline._DTYPE_BYTES
    for op in ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute"):
        for n in (0, 1, 4, 256):
            assert troofline._wire_factor(op, n) == \
                jroofline._wire_factor(op, n)


_pos = st.floats(0.0, 1e16, allow_nan=False)


@settings(max_examples=40, deadline=None)
@given(flops=_pos, byts=_pos, coll=_pos, tc=_pos, tm=_pos, tl=_pos,
       model=_pos, peak=_pos, n=st.integers(1, 512))
def test_roofline_properties_equal_the_reference(flops, byts, coll, tc, tm,
                                                 tl, model, peak, n):
    kw = dict(arch="a", shape="train_4k", mesh="single",
              flops_per_chip=flops, bytes_per_chip=byts,
              coll_bytes_per_chip=coll, coll_breakdown={"total": coll},
              t_compute=tc, t_memory=tm, t_collective=tl, model_flops=model,
              peak_mem_bytes=peak, n_chips=n)
    got, want = troofline.Roofline(**kw), jroofline.Roofline(**kw)
    assert got.bottleneck == want.bottleneck
    assert got.t_bound == want.t_bound
    assert got.useful_ratio == want.useful_ratio
    scale = jroofline.mesh_lib.PEAK_FLOPS_BF16 / \
        troofline.mesh_lib.PEAK_FLOPS_BF16
    assert got.roofline_fraction == pytest.approx(
        want.roofline_fraction * scale, rel=1e-12, abs=0)
    g, w = got.to_dict(), want.to_dict()
    assert list(g) == list(w)
    assert {k: v for k, v in g.items() if k != "roofline_fraction"} == \
        {k: v for k, v in w.items() if k != "roofline_fraction"}


@pytest.mark.parametrize("size", ["tiny", "full"])
def test_model_flops_equal_the_reference(size):
    get = {"tiny": (jconfigs.get_tiny, tconfigs.get_tiny),
           "full": (jconfigs.get_config, tconfigs.get_config)}[size]
    for arch in ARCHS:
        jc, tc = get[0](arch), get[1](arch)
        assert troofline.active_param_count(tc) == \
            jroofline.active_param_count(jc)
        for tokens in (1, 4096, 256 * 4096):
            assert troofline.model_flops_train(tc, tokens) == \
                jroofline.model_flops_train(jc, tokens)
            assert troofline.model_flops_prefill(tc, tokens) == \
                jroofline.model_flops_prefill(jc, tokens)
            assert troofline.model_flops_decode(tc, tokens) == \
                jroofline.model_flops_decode(jc, tokens)


# --------------------------------------------------------------------------
# tables
# --------------------------------------------------------------------------

def _rows() -> list:
    """Cell rows as ``run_cell`` writes them: single-mesh cells, an
    extrapolated one, a failure, multi-mesh cells and a row for a
    ``long_500k`` cell the table skips."""
    rng = np.random.default_rng(0)
    rows = []
    for i, (arch, shape) in enumerate(jconfigs.grid()[:9]):
        for mesh in ("single", "multi"):
            if i == 3 and mesh == "single":
                rows.append(dict(arch=arch, shape=shape, mesh=mesh, ok=False,
                                 seconds=1.5, error="RuntimeError: no rule\n"
                                 "Traceback ...", memory=None,
                                 roofline=None))
                continue
            t = rng.uniform(1e-4, 1.0, 3)
            rf = jroofline.Roofline(
                arch=arch, shape=shape,
                mesh=mesh + ("*" if i == 5 else ""),
                flops_per_chip=float(rng.uniform(1e12, 1e15)),
                bytes_per_chip=float(rng.uniform(1e9, 1e13)),
                coll_bytes_per_chip=float(rng.uniform(0, 1e11)),
                coll_breakdown={"total": 1.0}, t_compute=float(t[0]),
                t_memory=float(t[1]), t_collective=float(t[2]),
                model_flops=float(rng.uniform(1e15, 1e18)),
                peak_mem_bytes=float(rng.uniform(1e9, 1e11)), n_chips=256)
            rows.append(dict(arch=arch, shape=shape, mesh=mesh, ok=True,
                             seconds=float(rng.uniform(1, 60)), error="",
                             memory={"per_chip_total":
                                     float(rng.uniform(1e9, 1e11))},
                             roofline=rf.to_dict()))
    rows.append(dict(arch="deepseek-7b", shape="long_500k", mesh="single",
                     ok=False, seconds=0.0, error="x", memory=None,
                     roofline=None))
    return rows


def _roofline(pkg, d):
    names = {f.name for f in dataclasses.fields(pkg.Roofline)}
    return pkg.Roofline(**{k: v for k, v in d.items() if k in names})


def test_tables_are_byte_equal_to_the_reference(tmp_path, monkeypatch):
    rows = _rows()
    for r in rows:
        (tmp_path / f"{r['arch']}_{r['shape']}_{r['mesh']}.json") \
            .write_text(json.dumps(r))
    loaded = ttabulate.load(str(tmp_path))
    assert loaded == jtabulate.load(str(tmp_path))
    for md in (False, True):
        assert ttabulate.render(loaded, md=md) == \
            jtabulate.render(loaded, md=md)
    ok = [r["roofline"] for r in rows if r["ok"]]
    # the roofline column divides by the peak: the reference's here
    monkeypatch.setattr(troofline.mesh_lib, "PEAK_FLOPS_BF16",
                        jroofline.mesh_lib.PEAK_FLOPS_BF16)
    assert troofline.render_table([_roofline(troofline, d) for d in ok]) \
        == jroofline.render_table([_roofline(jroofline, d) for d in ok])


_PERF_REF = r"""
import json, os, sys
import repro.launch.dryrun as d
row = json.load(open(sys.argv[1]))
d.run_cell = lambda *a, **k: d.CellResult(**row)
from repro.launch import perf
os.chdir(sys.argv[2])
sys.exit(perf.main(sys.argv[3:]))
"""


def test_perf_output_is_byte_equal_to_the_reference(tmp_path, monkeypatch,
                                                    capsys):
    rows = [r for r in _rows() if r["ok"]]
    base, new = rows[0], dict(rows[2], arch=rows[0]["arch"],
                              shape=rows[0]["shape"])
    (tmp_path / "experiments/dryrun").mkdir(parents=True)
    (tmp_path / "experiments/dryrun"
     / f"{base['arch']}_{base['shape']}_single.json").write_text(
        json.dumps(base))
    (tmp_path / "new.json").write_text(json.dumps(new))
    argv = ["--arch", base["arch"], "--shape", base["shape"], "--name",
            "variant"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    ref = subprocess.run([sys.executable, "-c", _PERF_REF,
                          str(tmp_path / "new.json"), str(tmp_path)] + argv,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert ref.returncode == 0, ref.stderr[-2000:]
    monkeypatch.setattr(tdryrun, "run_cell",
                        lambda *a, **k: tdryrun.CellResult(**new))
    monkeypatch.chdir(tmp_path)
    from repro_torch.launch import perf
    capsys.readouterr()
    assert perf.main(argv) == 0
    assert capsys.readouterr().out == ref.stdout
    written = tmp_path / f"experiments/perf/{base['arch']}_{base['shape']}"
    assert json.loads((written / "variant.json").read_text()) == new


# --------------------------------------------------------------------------
# input stand-ins and shardings
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_equal_the_reference(arch):
    jc, tc = jconfigs.get_config(arch), tconfigs.get_config(arch)
    for shape_name in jconfigs.applicable_shapes(arch):
        js, ts = jconfigs.SHAPES[shape_name], tconfigs.SHAPES[shape_name]
        if js.kind in ("train", "prefill"):
            want = jspecs.train_like_specs(jc, js)
            got = tspecs.train_like_specs(tc, ts)
            assert list(got) == list(want)
            for k in want:
                assert tuple(got[k].shape) == want[k].shape
                assert _dtype(got[k]) == _dtype(want[k])
                assert got[k].device.type == "meta"
            continue
        want = jspecs.decode_state_specs(jc, js)
        got = tspecs.decode_state_specs(tc, ts)
        for g, w in zip(got[:2], want[:2]):
            assert tuple(g.shape) == w.shape and _dtype(g) == _dtype(w)
        jstate = _jflat(want[2], jax.ShapeDtypeStruct)
        tstate = _tflat(got[2])
        assert set(tstate) == set(jstate)
        for p, w in jstate.items():
            assert tuple(tstate[p].shape) == w.shape
            assert _dtype(tstate[p]) == _dtype(w)
        assert (got[3] is None) == (want[3] is None)
        if want[3] is not None:
            for g, w in zip(got[3], want[3]):
                assert tuple(g.shape) == w.shape and _dtype(g) == _dtype(w)
    assert tspecs.ENC_MEMORY_LEN == jspecs.ENC_MEMORY_LEN


@pytest.mark.parametrize("mesh_name", ["single", "multi"])
def test_decode_shardings_and_zero1_equal_the_reference(mesh_name):
    mesh = MESHES[mesh_name]
    ref_zero1 = _ref_function("zero1", {"jax": jax})
    for arch in ARCHS:
        jc, tc = jconfigs.get_config(arch), tconfigs.get_config(arch)
        for shape_name in jconfigs.applicable_shapes(arch):
            shape = tconfigs.SHAPES[shape_name]
            if shape.kind != "decode":
                continue
            jrules = ref_rules_for(arch, "decode")
            trules = tdryrun.rules_for(arch, "decode")
            tok, _, state, mem = jspecs.decode_state_specs(
                jc, jconfigs.SHAPES[shape_name])
            t_tok, t_pos, t_state, t_mem = tspecs.decode_shardings(
                tc, shape, mesh, trules)
            want_tok = japi.filter_spec(tok.shape, jrules.spec("batch"),
                                        mesh)
            assert tuple(t_tok) == tuple(t_pos) == tuple(want_tok)
            flat = _tflat(t_state)
            for path, leaf in _jflat(state, jax.ShapeDtypeStruct).items():
                axes = jspecs._state_logical_axes(
                    [jax.tree_util.DictKey(k) if isinstance(k, str)
                     else jax.tree_util.SequenceKey(k) for k in path])
                axes = tuple(axes) + (None,) * (len(leaf.shape) - len(axes))
                want = jspecs._filtered(leaf, axes[: len(leaf.shape)],
                                        mesh, jrules)
                assert tuple(flat[path]) == tuple(want), (arch, path)
            if mem is not None:
                assert tuple(t_mem[0]) == tuple(japi.filter_spec(
                    mem[0].shape, jrules.spec("batch", None, "embed"), mesh))
        jrules = ref_rules_for(arch, "train")
        trules = tdryrun.rules_for(arch, "train")
        jstruct = jax.eval_shape(lambda: jinit_lm(jax.random.PRNGKey(0),
                                                  jc))
        with FakeTensorMode():
            tstruct = tinit_lm(torch.Generator("cpu"), tc, device="cpu")
        want = _jflat(ref_zero1(jparams.physical_specs(jstruct, mesh, jrules),
                                jstruct, mesh, jrules), japi.P)
        got = _tflat(tdryrun.zero1(
            tparams.physical_specs(tstruct, mesh, trules), tstruct, mesh,
            trules))
        assert set(got) == set(want)
        for p in want:
            assert tuple(got[p]) == tuple(want[p]), (arch, p)
