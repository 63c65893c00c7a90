"""The port's model substrate and configs against the JAX package, on the CPU.

The same parameters (the reference's ``init_lm``, carried across with
``convert.params_from_numpy``) and the same inputs (numpy, from a seed)
go through ``repro.models`` and ``repro_torch.models``.  Tolerances:
float32 compute rtol/atol 1e-4 (the same float32 operations, summed in
another order by another matmul library); bfloat16 compute 0.15 / 0.15,
the reference's own bound for bf16 paths (tests/test_models.py), since the
two frameworks round bf16 intermediates at different places; routing
(``top_e``, ``expert_load``, ``dropped``) exactly.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as jattn
from repro.models import forward as jforward
from repro.models import init_lm as jinit_lm
from repro.models import lm_loss as jlm_loss
from repro.models import moe as jmoe
from repro.models import common as jcommon
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_numpy
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import forward as tforward
from repro_torch.models import init_lm as tinit_lm
from repro_torch.models import lm_loss as tlm_loss
from repro_torch.models import moe as tmoe

ARCHS = jconfigs.ARCHS
F32 = (1e-4, 1e-4)
BF16 = (0.15, 0.15)
_DTYPES = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}


@functools.lru_cache(maxsize=None)
def jax_params(arch: str):
    """The reference's tiny parameters (float32 masters whatever the
    compute dtype), as JAX arrays and as numpy."""
    jp = jinit_lm(jax.random.PRNGKey(0), jconfigs.get_tiny(arch))
    return jp, jax.tree.map(np.asarray, jp)


def cfg_pair(arch: str, dtype: str = "bf16", **updates):
    """(reference, port) tiny configs with the same updates; ``dtype``
    "f32" computes in float32."""
    jc, tc = jconfigs.get_tiny(arch), tconfigs.get_tiny(arch)
    if dtype == "f32":
        jc = dataclasses.replace(jc, compute_dtype=jnp.float32)
        tc = dataclasses.replace(tc, compute_dtype=torch.float32)
    return (dataclasses.replace(jc, **updates),
            dataclasses.replace(tc, **updates))


def batch_np(cfg, s=8, b=2, seed=0) -> dict:
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.enc_layers:
        out["frontend"] = rng.standard_normal(
            (b, 12, cfg.frontend_dim)).astype(np.float32)
    elif cfg.frontend_dim:
        out["frontend"] = rng.standard_normal(
            (b, cfg.num_prefix, cfg.frontend_dim)).astype(np.float32)
    return out


def to_j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def to_t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def close(t, j, tol):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32),
                               rtol=tol[0], atol=tol[1])


def _mapped(v):
    return _DTYPES.get(v, v)


@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_configs_equal_the_reference(arch):
    """Every field of config() and tiny(), dtypes mapped to torch's, and
    the analytic parameter count of the full config."""
    for get in ("get_config", "get_tiny"):
        j, t = getattr(jconfigs, get)(arch), getattr(tconfigs, get)(arch)
        for f in dataclasses.fields(j):
            assert getattr(t, f.name) == _mapped(getattr(j, f.name)), \
                (arch, get, f.name)
        assert (t.hd, t.num_groups, t.tail_pattern, t.lru) == \
            (j.hd, j.num_groups, j.tail_pattern, j.lru)
    assert tconfigs.get_config(arch).param_count() \
        == jconfigs.get_config(arch).param_count()


def test_config_tables_equal_the_reference():
    assert tconfigs.ARCHS == jconfigs.ARCHS
    assert {k: dataclasses.astuple(v) for k, v in tconfigs.SHAPES.items()} \
        == {k: dataclasses.astuple(v) for k, v in jconfigs.SHAPES.items()}
    assert tconfigs.grid() == jconfigs.grid()
    for a in jconfigs.ARCHS:
        assert tconfigs.applicable_shapes(a) == jconfigs.applicable_shapes(a)
    assert [f.name for f in dataclasses.fields(tcommon.ModelConfig)] == \
        [f.name for f in dataclasses.fields(jcommon.ModelConfig)]
    assert tconfigs.get_config("deepseek-7b").param_count() == 6_910_361_600


@pytest.mark.parametrize("arch", ARCHS)
def test_init_lm_has_the_reference_structure(arch):
    """The port's own init draws a tree with the reference's keys, shapes
    and dtypes, and the fan-in scale of dense_init."""
    _, jnp_tree = jax_params(arch)
    cfg = tconfigs.get_tiny(arch)
    tp = tinit_lm(torch.Generator().manual_seed(0), cfg, device="cpu")
    shapes = jax.tree.map(lambda a: (a.shape, a.dtype.name), jnp_tree)
    assert tcommon.tree_map(
        lambda x: (tuple(x.shape), str(x.dtype).removeprefix("torch.")),
        tp) == shapes
    emb = tp["embed"].numpy()
    assert abs(emb.std() * np.sqrt(cfg.d_model) - 1.0) < 0.05


def test_init_lm_refuses_a_generator_on_another_device():
    with pytest.raises(ValueError, match="generator"):
        tinit_lm(torch.Generator(), tconfigs.get_tiny("deepseek-7b"),
                 device="meta")


def test_params_from_numpy_keeps_structure_dtypes_and_values():
    tree = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
            "g": [{"b0": {"w": np.array([1.5, -2.25], ml_dtypes.bfloat16)}},
                  {"b0": {"w": np.array([3, 4], np.int32)}}]}
    out = params_from_numpy(tree, device="cpu")
    assert out["a"].dtype == torch.float32 and out["a"].shape == (2, 3)
    assert out["g"][0]["b0"]["w"].dtype == torch.bfloat16
    assert out["g"][0]["b0"]["w"].tolist() == [1.5, -2.25]
    assert out["g"][1]["b0"]["w"].dtype == torch.int32
    out["a"][0, 0] = 99.0                        # copied, not shared
    assert tree["a"][0, 0] == 0.0
    _, jnp_tree = jax_params("qwen3-32b")
    tp = params_from_numpy(jnp_tree, device="cpu")
    assert list(tp) == list(jnp_tree)
    assert len(tp["groups"]) == len(jnp_tree["groups"])
    np.testing.assert_array_equal(
        tp["groups"][1]["b0"]["attn"]["q_norm"].numpy(),
        jnp_tree["groups"][1]["b0"]["attn"]["q_norm"])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_norm_rope_softcap_keep_the_reference_casts(dtype):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32) * 0.1
    pos = np.tile(np.arange(5, dtype=np.int32) * 7, (2, 1))
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" \
        else (jnp.bfloat16, torch.bfloat16)
    jx, tx = jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)
    tol = F32 if dtype == "f32" else (1e-2, 1e-2)
    a = tcommon.rms_norm(tx, torch.from_numpy(scale))
    assert a.dtype == tdt
    close(a, jcommon.rms_norm(jx, jnp.asarray(scale)), tol)
    r = tcommon.rope(tx, torch.from_numpy(pos), 10_000.0)
    assert r.dtype == tdt
    close(r, jcommon.rope(jx, jnp.asarray(pos), 10_000.0), tol)
    close(tcommon.softcap(tx, 3.0), jcommon.softcap(jx, 3.0), tol)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_the_reference(arch, dtype):
    jc, tc = cfg_pair(arch, dtype)
    jp, np_tree = jax_params(arch)
    tp = params_from_numpy(np_tree, device="cpu")
    batch = batch_np(jc)
    jl, jaux = jax.jit(functools.partial(jforward, cfg=jc))(jp, to_j(batch))
    tl, taux = tforward(tp, to_t(batch), tc)
    assert tl.dtype == torch.float32 and tuple(tl.shape) == jl.shape
    close(tl, jl, F32 if dtype == "f32" else BF16)
    assert set(taux) == set(jaux)
    if jaux and dtype == "f32":
        np.testing.assert_array_equal(taux["expert_load"].numpy(),
                                      np.asarray(jaux["expert_load"]))
        assert int(taux["dropped"]) == int(jaux["dropped"])


def test_lm_loss_matches_the_reference():
    jc, tc = cfg_pair("grok-1-314b", "f32")
    jp, np_tree = jax_params("grok-1-314b")
    tp = params_from_numpy(np_tree, device="cpu")
    batch = batch_np(jc, s=12)
    jl, jm = jax.jit(functools.partial(jlm_loss, cfg=jc))(jp, to_j(batch))
    tl, tm = tlm_loss(tp, to_t(batch), tc)
    close(tl, jl, F32)
    assert set(tm) == set(jm) and int(tm["tokens"]) == int(jm["tokens"])
    close(tm["moe_aux"], jm["moe_aux"], F32)


def _moe_inputs(cfg, b, s, seed):
    x = np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)
    return x


@pytest.mark.parametrize("capacity", [None, 0.1])
@pytest.mark.parametrize("arch", ["grok-1-314b", "arctic-480b"])
def test_moe_ffn_matches_the_reference(arch, capacity):
    """Routing exactly (``top_e``, ``expert_load``, ``dropped``, capacity
    0.1 forcing drops) and ``y`` at float32 tolerance."""
    updates = {} if capacity is None else {"capacity_factor": capacity}
    jc, tc = cfg_pair(arch, "f32", **updates)
    _, np_tree = jax_params(arch)
    p_np = np_tree["groups"][0]["b0"]["ffn"]
    p_t = params_from_numpy(p_np, device="cpu")
    x = _moe_inputs(jc, 2, 64, seed=5)
    jy, jaux = jax.jit(functools.partial(jmoe.moe_ffn, cfg=jc))(
        jax.tree.map(jnp.asarray, p_np), jnp.asarray(x))
    ty, taux = tmoe.moe_ffn(p_t, torch.from_numpy(x), tc)
    _, j_top = jax.lax.top_k(jax.nn.softmax(jnp.asarray(x) @ p_np["router"]),
                             jc.top_k)
    _, t_top = torch.topk(torch.softmax(torch.from_numpy(x) @ p_t["router"],
                                        -1), tc.top_k)
    np.testing.assert_array_equal(t_top.numpy(), np.asarray(j_top))
    np.testing.assert_array_equal(taux["expert_load"].numpy(),
                                  np.asarray(jaux["expert_load"]))
    assert int(taux["dropped"]) == int(jaux["dropped"])
    if capacity is not None:
        assert int(taux["dropped"]) > 0
    close(ty, jy, F32)
    close(taux["aux_loss"], jaux["aux_loss"], F32)


def _attn_case(arch, s):
    jc, tc = cfg_pair(arch, "f32")
    _, np_tree = jax_params(arch)
    p_np = np_tree["groups"][0]["b0"]["attn"]
    x = np.random.default_rng(7).standard_normal(
        (2, s, jc.d_model)).astype(np.float32)
    pos = np.tile(np.arange(s, dtype=np.int32), (2, 1))
    return (jc, tc, jax.tree.map(jnp.asarray, p_np),
            params_from_numpy(p_np, device="cpu"), x, pos)


def test_attention_blockwise_matches_the_reference():
    jc, tc, jp, tp, x, pos = _attn_case("qwen3-32b", 32)
    j = jax.jit(functools.partial(jattn.attention_blockwise, cfg=jc,
                                  q_chunk=8))(jp, jnp.asarray(x),
                                              jnp.asarray(pos))
    t = tattn.attention_blockwise(tp, torch.from_numpy(x),
                                  torch.from_numpy(pos), tc, q_chunk=8)
    close(t, j, F32)
    full = tattn.attention(tp, torch.from_numpy(x), torch.from_numpy(pos),
                           tc, window=None)
    close(t, full.numpy(), F32)


def test_attention_chunked_local_matches_the_reference():
    jc, tc, jp, tp, x, pos = _attn_case("gemma3-1b", 32)   # window 8
    j = jax.jit(functools.partial(jattn.attention_chunked_local, cfg=jc,
                                  window=jc.window))(jp, jnp.asarray(x),
                                                     jnp.asarray(pos))
    t = tattn.attention_chunked_local(tp, torch.from_numpy(x),
                                      torch.from_numpy(pos), tc,
                                      window=tc.window)
    close(t, j, F32)
    banded = tattn.attention(tp, torch.from_numpy(x), torch.from_numpy(pos),
                             tc, window=tc.window)
    close(t, banded.numpy(), F32)


@pytest.mark.parametrize("arch", ["qwen3-32b", "gemma3-1b", "grok-1-314b"])
def test_opt_level_1_equals_opt_level_0(arch):
    """The repeated-KV layout gives the grouped layout's logits, and the
    reference's at opt_level 1."""
    jc, tc = cfg_pair(arch, "f32", opt_level=1)
    jp, np_tree = jax_params(arch)
    tp = params_from_numpy(np_tree, device="cpu")
    batch = batch_np(jc, s=16)
    t1, _ = tforward(tp, to_t(batch), tc)
    t0, _ = tforward(tp, to_t(batch), dataclasses.replace(tc, opt_level=0))
    close(t1, t0.numpy(), (1e-5, 1e-5))
    j1, _ = jax.jit(functools.partial(jforward, cfg=jc))(jp, to_j(batch))
    close(t1, j1, F32)


def test_scan_layers_equals_unrolled():
    """The port's one loop gives the reference's ``lax.scan`` over the
    stacked groups (``scan_layers=True``) and its unrolled loop, on the
    same parameters; the port keeps the argument for the API alone."""
    jc, tc = cfg_pair("deepseek-7b", "f32", num_layers=4)
    jp = jinit_lm(jax.random.PRNGKey(0), jc)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    batch = batch_np(jc, s=16)
    t, _ = tforward(tp, to_t(batch), tc, scan_layers=True)
    for scan in (True, False):
        j, _ = jax.jit(functools.partial(jforward, cfg=jc,
                                         scan_layers=scan))(jp, to_j(batch))
        close(t, j, F32)


def test_local_impl_chunked_equals_masked():
    _, tc = cfg_pair("gemma3-1b", "f32")
    tp = tinit_lm(torch.Generator().manual_seed(0), tc, device="cpu")
    batch = to_t(batch_np(tc, s=32))
    a, _ = tforward(tp, batch, tc, local_impl="mask")
    b, _ = tforward(tp, batch, tc, local_impl="chunked")
    close(a, b.numpy(), F32)

