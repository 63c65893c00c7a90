"""The port's training path against the JAX package, on the CPU.

AdamW, compression, ``lm_loss`` gradients, ``make_train_step`` and the
``Trainer``: the same trees (the reference's ``init_lm``, carried across
with ``convert.params_from_numpy``) and the same inputs (numpy, from a
seed) go through ``repro`` and ``repro_torch``.  Tolerances: AdamW rtol
1e-6 (the same float32 operations, a few ulps apart where pow and fused
multiply-adds round differently) with atol 1e-8 (a parameter the step
brings near 0 keeps the step's own error, lr x a few ulps); gradients rtol 1e-4 with atol 1e-6 in float32 (the same
products summed in another order by another library; small gradients sit
near the atol; rwkv6 atol 1e-5, see ``GRAD_RWKV``); losses over training steps rtol 1e-4; the top-k mask and
the int8 codes exactly.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import init_lm as jinit_lm
from repro.models import lm_loss as jlm_loss
from repro.optim import adamw as jadamw
from repro.optim import compression as jcomp
from repro.train import step as jstep
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.models.common import tree_items
from repro_torch.optim import adamw, compression
from repro_torch.train import step as tstep
from repro_torch.train.trainer import Trainer, TrainerConfig

ARCHS = jconfigs.ARCHS
ADAM = (1e-6, 1e-8)
GRAD = (1e-4, 1e-6)
#: rwkv6's tiny loss is ill-conditioned in float32 (its per-head group
#: norm divides by the norm of each head's output): on most batch seeds
#: the reference's own float32 gradients differ from a float64 evaluation
#: by more than GRAD, up to ~1e-4 of a leaf's largest entry, and the
#: port's by as much
GRAD_RWKV = (1e-4, 1e-5)


@functools.lru_cache(maxsize=None)
def np_params(arch: str):
    """The reference's tiny float32 masters as numpy."""
    return jax.tree.map(np.asarray,
                        jinit_lm(jax.random.PRNGKey(0),
                                 jconfigs.get_tiny(arch)))


def cfg_pair(arch: str, **updates):
    """(reference, port) tiny configs computing in float32."""
    jc = dataclasses.replace(jconfigs.get_tiny(arch),
                             compute_dtype=jnp.float32, **updates)
    tc = dataclasses.replace(tconfigs.get_tiny(arch),
                             compute_dtype=torch.float32, **updates)
    return jc, tc


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


def to_j(tree):
    return jax.tree.map(jnp.asarray, tree)


def to_t(tree):
    return params_from_numpy(tree, device="cpu")


def assert_trees_close(t_tree, j_tree, tol):
    """Every leaf of the port's tree against the reference's, matched by
    key path."""
    jt = dict(tree_items(jax.tree.map(np.asarray, j_tree)))
    tt = dict(tree_items(t_tree))
    assert list(tt) == list(jt)
    for path, t in tt.items():
        np.testing.assert_allclose(
            t.detach().numpy().astype(np.float64),
            np.asarray(jt[path], np.float64), rtol=tol[0], atol=tol[1],
            err_msg=str(path))


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def test_schedule_matches_the_reference():
    cfg = adamw.AdamWConfig(lr=2e-3, warmup_steps=10, total_steps=50)
    jcfg = jadamw.AdamWConfig(lr=2e-3, warmup_steps=10, total_steps=50)
    steps = np.arange(0, 61, dtype=np.int32)
    t = adamw.schedule(cfg, torch.from_numpy(steps))
    j = jadamw.schedule(jcfg, jnp.asarray(steps))
    assert t.dtype == torch.float32
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6,
                               atol=0)


def _adam_tree(seed):
    """Matrices (decayed), vectors (not) and a rank-3 leaf, in dicts and a
    list whose keys do not come sorted."""
    rng = np.random.default_rng(seed)

    def a(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    return {"w": a(6, 5), "b": a(5), "groups": [{"z": a(3, 4, 2),
                                                  "a": a(7)}, {"z": a(2, 2),
                                                               "a": a(1)}]}


@pytest.mark.parametrize("clip,grad_scale", [(1.0, 10.0), (1.0, 0.01),
                                             (0.0, 1.0)])
def test_update_matches_the_reference(clip, grad_scale):
    """Three updates from the same params and grads: params, moments,
    step, grad norm and learning rate; clipping on (clipped and not) and
    off; weight decay only on rank >= 2."""
    kw = dict(lr=0.05, warmup_steps=2, total_steps=10, clip_norm=clip,
              weight_decay=0.1)
    cfg, jcfg = adamw.AdamWConfig(**kw), jadamw.AdamWConfig(**kw)
    p_np = _adam_tree(0)
    tp, jp = to_t(p_np), to_j(p_np)
    ts, js = adamw.init(tp), jadamw.init(jp)
    for i in range(3):
        g_np = jax.tree.map(lambda x: x * grad_scale, _adam_tree(i + 1))
        tp, ts, tm = adamw.update(cfg, to_t(g_np), ts, tp)
        jp, js, jm = jax.jit(functools.partial(jadamw.update, jcfg))(
            to_j(g_np), js, jp)
        assert int(ts["step"]) == int(js["step"]) == i + 1
        assert ts["step"].dtype == torch.int32
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-6)
        assert_trees_close(tp, jp, ADAM)
        assert_trees_close(ts["mu"], js["mu"], ADAM)
        assert_trees_close(ts["nu"], js["nu"], ADAM)


def test_update_decays_matrices_only():
    """Zero gradients: only the decay moves a parameter, and only a
    matrix's."""
    cfg = adamw.AdamWConfig(lr=0.5, warmup_steps=0, total_steps=10,
                            weight_decay=0.2, clip_norm=1.0)
    p = {"m": torch.ones(2, 3), "v": torch.ones(3)}
    g = {"m": torch.zeros(2, 3), "v": torch.zeros(3)}
    p, _, metrics = adamw.update(cfg, g, adamw.init(p), p)
    assert float(metrics["grad_norm"]) == 0.0
    torch.testing.assert_close(p["v"], torch.ones(3))
    torch.testing.assert_close(
        p["m"], torch.full((2, 3), 1 - float(metrics["lr"]) * 0.2))


def test_adamw_descends_quadratic():
    cfg = adamw.AdamWConfig(lr=0.1, warmup_steps=0, total_steps=100,
                            weight_decay=0.0, clip_norm=0)
    params = {"w": torch.ones((4,)) * 5.0}
    state = adamw.init(params)
    for _ in range(60):
        grads = {"w": 2 * params["w"]}
        params, state, m = adamw.update(cfg, grads, state, params)
    assert float(torch.max(torch.abs(params["w"]))) < 1.0
    assert int(state["step"]) == 60


def test_grad_clip_and_schedule():
    cfg = adamw.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                            clip_norm=1.0)
    s0 = adamw.schedule(cfg, torch.tensor(0))
    s5 = adamw.schedule(cfg, torch.tensor(5))
    s10 = adamw.schedule(cfg, torch.tensor(10))
    assert float(s0) == 0.0 and float(s5) == pytest.approx(0.5)
    assert float(s10) == pytest.approx(1.0)
    params = {"w": torch.zeros((3,))}
    state = adamw.init(params)
    _, _, m = adamw.update(cfg, {"w": torch.ones((3,)) * 100}, state,
                           params)
    assert float(m["grad_norm"]) == pytest.approx(100 * np.sqrt(3), rel=1e-5)


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------

def test_int8_error_feedback_converges():
    """With error feedback, quantised SGD still drives a quadratic to zero."""
    def grad_fn(params, batch):
        return {"w": 2 * params["w"]}, {}
    f = compression.wrap_grad_fn(grad_fn, "int8")
    params = {"w": torch.ones((8,)) * 3.0}
    err = compression.init_error(params)
    for _ in range(200):
        g, _, err = f(params, None, err)
        params = {"w": params["w"] - 0.05 * g["w"]}
    assert float(torch.max(torch.abs(params["w"]))) < 0.05


def test_topk_compression_sparsity():
    def grad_fn(params, batch):
        return {"w": torch.arange(100.0)}, {}
    f = compression.wrap_grad_fn(grad_fn, "topk", topk_frac=0.1)
    params = {"w": torch.zeros(100)}
    g, _, err = f(params, None, compression.init_error(params))
    nz = int(torch.sum(g["w"] != 0))
    assert nz == 10
    # residual carries the rest
    assert float(torch.sum(err["w"])) == pytest.approx(
        float(torch.sum(torch.arange(100.0))) - float(torch.sum(g["w"])))


@pytest.mark.parametrize("mode", ["int8", "topk"])
def test_compression_matches_the_reference(mode):
    """Two rounds of error feedback on tie-free gradients: the compressed
    gradients and the carried errors, the top-k mask and int8 codes
    exactly."""
    g_np = {"w": np.random.default_rng(0).permutation(
        np.arange(1, 61, dtype=np.float32) / 7).reshape(6, 10),
        "b": np.linspace(-3, 2, 17, dtype=np.float32)}

    def t_fn(p, b):
        return to_t(g_np), {}

    def j_fn(p, b):
        return to_j(g_np), {}
    tf = compression.wrap_grad_fn(t_fn, mode, topk_frac=0.2)
    jf = jcomp.wrap_grad_fn(j_fn, mode, topk_frac=0.2)
    te, je = compression.init_error(to_t(g_np)), jcomp.init_error(to_j(g_np))
    for _ in range(2):
        tg, _, te = tf(None, None, te)
        jg, _, je = jf(None, None, je)
        assert_trees_close(tg, jg, (1e-6, 1e-7))
        assert_trees_close(te, je, (1e-6, 1e-7))
    x = g_np["w"] - 1.0
    np.testing.assert_array_equal(
        compression.topk_mask(torch.from_numpy(x), 0.3).numpy(),
        np.asarray(jcomp.topk_mask(jnp.asarray(x), 0.3)))
    tq, ts = compression._quant_int8(torch.from_numpy(x))
    jq, js = jcomp._quant_int8(jnp.asarray(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert float(ts) == pytest.approx(float(js), rel=1e-7)


# ---------------------------------------------------------------------------
# gradients and the train step
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_grad(arch: str, s: int):
    jc, _ = cfg_pair(arch)
    batch = batch_np(jc, s=s)
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: jlm_loss(p, b, jc)[0]))
    loss, g = fn(to_j(np_params(arch)), to_j(batch))
    return float(loss), g


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_gradients_match_jax_grad(arch):
    """Every leaf's gradient in float32, against ``jax.grad`` of the
    reference's loss; ``remat`` on (the tiny configs' default) and off
    give equal gradients."""
    jc, tc = cfg_pair(arch)
    assert tc.remat
    # rwkv's chunked form takes whole chunks (8 in the tiny config)
    s = 16 if arch == "rwkv6-1.6b" else 12
    batch = {k: torch.from_numpy(v) for k, v in batch_np(jc, s=s).items()}
    loss_fn = tstep.make_loss_fn(tc)
    (loss, _), grads = tstep._value_and_grad(loss_fn, to_t(np_params(arch)),
                                             batch)
    j_loss, j_grads = _jax_grad(arch, s)
    assert float(loss) == pytest.approx(j_loss, rel=1e-5)
    for _, g in tree_items(grads):
        assert g.dtype == torch.float32
    assert_trees_close(grads, j_grads,
                       GRAD_RWKV if arch == "rwkv6-1.6b" else GRAD)
    off = tstep.make_loss_fn(dataclasses.replace(tc, remat=False))
    (_, _), grads_off = tstep._value_and_grad(off, to_t(np_params(arch)),
                                              batch)
    for (_, a), (_, b) in zip(tree_items(grads), tree_items(grads_off)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _three_steps(arch, microbatch=None, compress="none", b=4, s=16,
                 reference=True):
    """Three steps of the port's and the reference's ``make_train_step``
    from the same params over the same batches: (port losses, reference
    losses, port params, reference params).

    AdamW's eps is 1e-3 here, not 1e-8: Adam divides by |g|, so with eps
    1e-8 a parameter whose gradient is ~1e-8 moves by up to lr one way or
    the other on the float32 rounding of that gradient (a few such
    parameters per tiny model), and parameters can only be held elementwise
    with eps above the gradients' rounding.  The update's arithmetic at
    the default eps is held in ``test_update_matches_the_reference``."""
    jc, tc = cfg_pair(arch)
    kw = dict(lr=3e-3, warmup_steps=1, total_steps=10, eps=1e-3)
    t_fn = tstep.make_train_step(tc, adamw.AdamWConfig(**kw),
                                 compress=compress, microbatch=microbatch)
    j_fn = jax.jit(jstep.make_train_step(jc, jadamw.AdamWConfig(**kw),
                                         compress=compress,
                                         microbatch=microbatch)) \
        if reference else None
    tp, jp = to_t(np_params(arch)), to_j(np_params(arch))
    ts, js = adamw.init(tp), jadamw.init(jp)
    te = je = None
    if compress != "none":
        te, je = compression.init_error(tp), jcomp.init_error(jp)
    t_losses, j_losses = [], []
    for i in range(3):
        batch = batch_np(jc, s=s, b=b, seed=i)
        tp, ts, tm, te = t_fn(tp, ts, {k: torch.from_numpy(v)
                                       for k, v in batch.items()}, te)
        t_losses.append(float(tm["loss"]))
        if j_fn is None:
            continue
        jp, js, jm, je = j_fn(jp, js, to_j(batch), je)
        j_losses.append(float(jm["loss"]))
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
    return t_losses, j_losses, tp, jp


@pytest.mark.parametrize("arch,compress", [("deepseek-7b", "none"),
                                           ("gemma3-1b", "int8"),
                                           ("grok-1-314b", "none")])
def test_train_step_matches_the_reference(arch, compress):
    """Losses of every step; the parameters after the third too where no
    compressor rounds the gradients (an int8 code or a top-k threshold
    turns float32 rounding of a gradient into a whole step of the code;
    the compressors themselves are held on fixed gradients above)."""
    t_losses, j_losses, tp, jp = _three_steps(arch, compress=compress)
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-4)
    if compress == "none":
        assert_trees_close(tp, jp, (1e-4, 1e-5))


def test_microbatches_match_the_full_batch_and_the_reference():
    """``microbatch=2`` accumulates to the full batch's mean loss and
    gradients (up to float32 rounding), and equals the reference's
    ``lax.scan`` accumulation."""
    arch = "qwen3-32b"
    t_mb, j_mb, tp_mb, jp_mb = _three_steps(arch, microbatch=2)
    np.testing.assert_allclose(t_mb, j_mb, rtol=1e-4)
    assert_trees_close(tp_mb, jp_mb, (1e-4, 1e-5))
    t_full, _, tp_full, _ = _three_steps(arch, reference=False)
    np.testing.assert_allclose(t_mb, t_full, rtol=1e-4)
    for (_, a), (_, b) in zip(tree_items(tp_mb), tree_items(tp_full)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-5)


def test_eval_step_and_trees_back_to_numpy():
    jc, tc = cfg_pair("qwen1.5-4b")
    batch = batch_np(jc, s=10)
    tm = tstep.make_eval_step(tc)(to_t(np_params("qwen1.5-4b")),
                                  {k: torch.from_numpy(v)
                                   for k, v in batch.items()})
    jm = jax.jit(jstep.make_eval_step(jc))(to_j(np_params("qwen1.5-4b")),
                                           to_j(batch))
    assert not tm["loss"].requires_grad
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    # an optimizer state crosses both ways with the reference's key order
    state = adamw.init(to_t(np_params("qwen1.5-4b")))
    back = params_to_numpy({"params": to_t(np_params("qwen1.5-4b")),
                            "opt": state})
    j_back = jax.tree.map(np.asarray, {"params": np_params("qwen1.5-4b"),
                                       "opt": jadamw.init(to_j(np_params(
                                           "qwen1.5-4b")))})
    flat = jax.tree_util.tree_flatten_with_path(j_back)[0]
    mine = tree_items(back)
    assert [tuple(getattr(k, "key", getattr(k, "idx", None)) for k in p)
            for p, _ in flat] == [p for p, _ in mine]
    assert list(back["params"]) == sorted(back["params"])
    for (_, a), (_, b) in zip(flat, mine):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the Trainer (the reference's tests/test_system.py cases)
# ---------------------------------------------------------------------------

def _trainer(tmp, steps=8, **kw):
    cfg = tconfigs.get_tiny("deepseek-7b")
    opt_cfg = adamw.AdamWConfig(lr=2e-3, warmup_steps=2, total_steps=steps)
    tcfg = TrainerConfig(**{**dict(steps=steps, batch_per_host=4, seq_len=32,
                                   ckpt_dir=str(tmp), ckpt_every=4,
                                   log_every=100), **kw})
    return Trainer(cfg, opt_cfg, tcfg, device="cpu")


def test_train_e2e_loss_drops_and_profiles(tmp_path):
    tr = _trainer(tmp_path, steps=10)
    tr.run()
    losses = [h["loss"] for h in tr.history]
    assert len(losses) == 10
    assert losses[-1] < losses[0]
    assert all(np.isfinite(h["grad_norm"]) for h in tr.history)
    rep = tr.profile_report()
    assert rep.total_slices > 0
    assert {"trainer", "data_loader", "ckpt_writer"} <= set(rep.worker_names)
    # checkpoints were written
    from repro_torch.ckpt import checkpoint
    assert checkpoint.latest_step(str(tmp_path)) == 10


def test_train_resume_from_checkpoint(tmp_path):
    tr = _trainer(tmp_path, steps=4)
    params, opt = tr.run()
    from repro_torch.ckpt import checkpoint
    assert checkpoint.latest_step(str(tmp_path)) == 4
    tr2 = _trainer(tmp_path, steps=6)
    params2, opt2, step = tr2.restore_or_init()
    assert step == 4
    tr2.loader.stop()
    tr.loader.stop()
    # the restored tree is the state the first run ended with
    for (_, a), (_, b) in zip(tree_items({"p": params, "o": opt}),
                              tree_items({"p": params2, "o": opt2})):
        assert a.dtype == b.dtype
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    # and a run from it takes the remaining two steps
    tr3 = _trainer(tmp_path, steps=6)
    _, opt3 = tr3.run(start_step=-1)
    assert len(tr3.history) == 2 and int(opt3["step"]) == 6


def test_slow_loader_detected(tmp_path):
    tr = _trainer(tmp_path, steps=6, loader_delay_s=0.05)
    tr.run()
    rep = tr.profile_report()
    names = [rep.path_str(p) for p in rep.paths[:3]]
    assert any("wait_data" in n or "data/generate" in n for n in names), names


def test_no_checkpoint_when_ckpt_every_is_zero(tmp_path):
    tr = _trainer(tmp_path, steps=2, ckpt_every=0)
    tr.run()
    from repro_torch.ckpt import checkpoint
    assert checkpoint.latest_step(str(tmp_path)) is None
