"""LM training in the PyTorch port against the JAX reference.

The same numpy inputs (and the reference's own parameters from
``repro.models.init``, carried over by ``repro_torch.convert``) go through
both packages in one process; qwen1.5's SMOKE model computes in f32.

* ``lm_loss``: the value (1e-5 relative) and every gradient leaf (2e-4 of
  the leaf's max abs) against ``jax.value_and_grad(repro.models.lm_loss)``,
  with several loss chunks and masked labels;
* ``adam_update`` over 3 steps (1e-6) and ``make_train_step`` over 3 steps
  (parameters 1e-5) against the reference's;
* ``tests/test_optim.py``'s ``TestAdam`` and ``TestPowerSGD`` mirrored, and
  PowerSGD against the reference from the reference's ``Q``;
* ``tests/test_checkpoint_runtime.py``'s five ``TestTrainer`` tests
  mirrored on the port's ``Trainer``;
* ``tests/test_archs_smoke.py::test_grad_step`` mirrored for qwen1.5 and
  mamba2 SMOKE (plain versions of K9 and K10 on the CPU).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import models as jmodels  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.configs import get_smoke_config as jsmoke  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import models as tmodels  # noqa: E402
from repro_torch import optim as toptim  # noqa: E402
from repro_torch.configs import get_smoke_config as tsmoke  # noqa: E402
from repro_torch.core import pytree as pt  # noqa: E402
from repro_torch.data import TokenPipeline  # noqa: E402
from repro_torch.launch import (  # noqa: E402
    init_opt_state,
    loss_and_grads,
    make_train_step,
    params_dict,
)
from repro_torch.runtime import Trainer, TrainerConfig  # noqa: E402

ARCH = "qwen1.5-0.5b"
B, S, CHUNK = 2, 24, 8  # three loss chunks


def _cfgs(arch=ARCH, **kw):
    return dataclasses.replace(jsmoke(arch), **kw), dataclasses.replace(tsmoke(arch), **kw)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _torch_tree(tree):
    return jax.tree_util.tree_map(lambda a: torch.as_tensor(np.asarray(a)), tree)


def _batch(cfg, step=0, masked=True):
    batch = TokenPipeline(cfg.vocab_size, B, S, seed=3).make_batch(step)
    if masked:
        batch["labels"] = batch["labels"].copy()
        batch["labels"][0, :5] = -1
        batch["labels"][1, -3:] = -1
    return batch


def test_lm_loss_and_gradients_match_reference():
    jcfg, tcfg = _cfgs(logits_chunk=CHUNK)
    ref_params = jmodels.init(jax.random.PRNGKey(0), jcfg)
    batch = _batch(jcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jmodels.lm_loss(p, b, jcfg), has_aux=True))(ref_params, jb)
    params = convert.train_params_from_numpy(_np_tree(ref_params), tcfg, device="cpu")
    loss, metrics, grads = loss_and_grads(tcfg, params, batch)
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    assert int(metrics["tokens"]) == int(jmet["tokens"]) == B * S - 8
    want = convert.model_state_from_numpy(_np_tree(jgrads), tcfg)
    assert set(want) == set(grads)
    for name, g in grads.items():
        scale = np.abs(want[name]).max()
        assert scale > 0, name
        assert np.abs(g.numpy() - want[name]).max() <= 2e-4 * scale, name


def test_mamba2_gradients_match_reference():
    """``test_grad_step[mamba2-1.3b]``'s path (K10 through ``SSDScan``'s
    plain arms on the CPU) against ``jax.value_and_grad`` of the reference's
    ``lm_loss`` (its chunked SSD scan) at SMOKE, to the qwen case's bars."""
    jcfg, tcfg = _cfgs("mamba2-1.3b", logits_chunk=CHUNK)
    ref_params = jmodels.init(jax.random.PRNGKey(0), jcfg)
    batch = _batch(jcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jmodels.lm_loss(p, b, jcfg), has_aux=True))(ref_params, jb)
    params = convert.train_params_from_numpy(_np_tree(ref_params), tcfg, device="cpu")
    loss, _, grads = loss_and_grads(tcfg, params, batch)
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    want = convert.model_state_from_numpy(_np_tree(jgrads), tcfg)
    assert set(want) == set(grads) and any(".ssm." in name for name in grads)
    for name, g in grads.items():
        scale = np.abs(want[name]).max()
        assert scale > 0, name
        assert np.abs(g.numpy() - want[name]).max() <= 2e-4 * scale, name


def test_adam_update_matches_reference():
    rng = np.random.default_rng(0)
    shapes = {"w": (5, 7), "b": (7,), "nested": {"m": (3, 2, 4)}}
    arrays = jax.tree_util.tree_map(lambda s: rng.standard_normal(s).astype(np.float32), shapes,
                                    is_leaf=lambda s: isinstance(s, tuple))
    jp, jstate = jax.tree_util.tree_map(jnp.asarray, arrays), None
    tp = _torch_tree(arrays)
    jstate, tstate = joptim.adam_init(jp), toptim.adam_init(tp)
    for step in range(3):
        g = jax.tree_util.tree_map(lambda a: rng.standard_normal(a.shape).astype(np.float32),
                                   arrays)
        jp, jstate = joptim.adam_update(jax.tree_util.tree_map(jnp.asarray, g), jstate, jp,
                                        lr=1e-2, weight_decay=0.1)
        tp, tstate = toptim.adam_update(_torch_tree(g), tstate, tp, lr=1e-2, weight_decay=0.1)
    assert int(tstate.count) == int(jstate.count) == 3
    for got, want in zip(pt.tree_leaves((tp, tstate.mu, tstate.nu)),
                         jax.tree_util.tree_leaves((jp, jstate.mu, jstate.nu))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_make_train_step_matches_reference():
    """Three steps in both packages: the first from both packages' fresh
    AdamW state, the other two from the reference's state after its first
    step, carried over (``convert.adam_state_from_numpy``)."""
    jcfg, tcfg = _cfgs()
    ref_params = jmodels.init(jax.random.PRNGKey(0), jcfg)
    jstep = jax.jit(jsteps.make_train_step(jcfg))
    tstep = make_train_step(tcfg)
    jp, jo = ref_params, jsteps.init_opt_state(ref_params)
    tp = convert.train_params_from_numpy(_np_tree(ref_params), tcfg, device="cpu")
    to = init_opt_state(tp)
    for step in range(3):
        batch = _batch(jcfg, step, masked=False)
        if step == 1:  # continue from the reference's parameters and AdamW state
            tp = convert.train_params_from_numpy(_np_tree(jp), tcfg, device="cpu")
            to = convert.adam_state_from_numpy(_np_tree(jo.mu), _np_tree(jo.nu), jo.count,
                                               cfg=tcfg, device="cpu")
        jp, jo, jm = jstep(jp, jo, {k: jnp.asarray(v) for k, v in batch.items()})
        tp, to, tm = tstep(tp, to, convert.train_batch_from_numpy(batch, device="cpu"))
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-5 * abs(float(jm["loss"]))
        assert float(tm["aux"]) == float(jm["aux"]) == 0.0
    want = convert.model_state_from_numpy(_np_tree(jp), tcfg)
    for name, p in tp.items():
        np.testing.assert_allclose(p.numpy(), want[name], rtol=0, atol=1e-5, err_msg=name)
    assert int(to.count) == 3


class TestAdam:
    def test_converges_on_quadratic(self):
        target = {"w": torch.tensor([1.0, -2.0, 3.0]), "b": torch.tensor([[0.5, -0.5]])}
        params = {k: torch.zeros_like(v) for k, v in target.items()}
        state = toptim.adam_init(params)

        def loss(p):
            d = pt.tree_sub(p, target)
            return pt.tree_dot(d, d)

        for _ in range(400):
            g = torch.func.grad(loss)(params)
            params, state = toptim.adam_update(g, state, params, lr=3e-2)
        assert float(loss(params)) < 1e-3


class TestPowerSGD:
    def test_compression_and_error_feedback(self):
        rng = np.random.default_rng(0)
        grads = {"w": torch.as_tensor(rng.standard_normal((64, 32))),
                 "b": torch.as_tensor(rng.standard_normal(32))}
        state = toptim.powersgd_init(grads, rank=4, generator=torch.Generator().manual_seed(0))
        ghat, state, metrics = toptim.compress_decompress(grads, state)
        assert metrics["compression_ratio"] > 4
        np.testing.assert_allclose(ghat["b"].numpy(), grads["b"].numpy())
        resid = grads["w"].numpy() - ghat["w"].numpy()
        np.testing.assert_allclose(state.error["w"].numpy(), resid, rtol=1e-4, atol=1e-5)

    def test_recycled_basis_tracks_static_subspace(self):
        rng = np.random.default_rng(1)
        u, v = rng.standard_normal((64, 4)), rng.standard_normal((32, 4))
        g = {"w": torch.as_tensor(u @ v.T)}
        state = toptim.powersgd_init(g, rank=4, generator=torch.Generator().manual_seed(0))
        errs = []
        for _ in range(5):
            ghat, state, _ = toptim.compress_decompress(g, state)
            errs.append(float(torch.linalg.norm(g["w"] - ghat["w"]) / torch.linalg.norm(g["w"])))
        assert errs[-1] < 1e-4
        assert errs[-1] <= errs[0] + 1e-6

    def test_matches_reference_from_its_basis(self):
        rng = np.random.default_rng(2)
        grads = {"w": rng.standard_normal((48, 3, 8)).astype(np.float32),
                 "b": rng.standard_normal(16).astype(np.float32)}
        jstate = joptim.powersgd_init(jax.tree_util.tree_map(jnp.asarray, grads), rank=4,
                                      key=jax.random.PRNGKey(0))
        tstate = convert.powersgd_state_from_numpy(_np_tree(jstate.q), _np_tree(jstate.error),
                                                   device="cpu")
        for _ in range(2):
            jg, jstate, jm = joptim.compress_decompress(
                jax.tree_util.tree_map(jnp.asarray, grads), jstate)
            tg, tstate, tm = toptim.compress_decompress(_torch_tree(grads), tstate)
            assert tm["compression_ratio"] == pytest.approx(float(jm["compression_ratio"]))
            for got, want in zip(pt.tree_leaves((tg, tstate.q, tstate.error)),
                                 jax.tree_util.tree_leaves((jg, jstate.q, jstate.error))):
                np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def _toy_step(state, batch):
    params, count = state
    shift = float(batch["tokens"].sum() % 7)
    params = {k: p - 0.01 * (p - shift) for k, p in params.items()}
    return (params, count + 1), {"count": count + 1}


def _state0():
    return ({"w": torch.ones(4)}, torch.zeros((), dtype=torch.int32))


class TestTrainer:
    def _pipeline(self):
        return TokenPipeline(vocab_size=97, batch=2, seq_len=16, seed=0)

    def test_uninterrupted_run(self, tmp_path):
        cfg = TrainerConfig(total_steps=12, checkpoint_every=4, checkpoint_dir=str(tmp_path),
                            async_checkpoint=False)
        out = Trainer(_toy_step, self._pipeline().make_batch, _state0(), cfg).run()
        assert out["final_step"] == 12

    def test_crash_replay_is_exact(self, tmp_path):
        pipe = self._pipeline()
        ref_cfg = TrainerConfig(total_steps=12, checkpoint_every=3,
                                checkpoint_dir=str(tmp_path / "ref"), async_checkpoint=False)
        ref = Trainer(_toy_step, pipe.make_batch, _state0(), ref_cfg).run()
        fails = {5: True, 8: True}

        def fault_hook(step):
            if fails.pop(step, False):
                raise RuntimeError("injected device failure")

        cfg = TrainerConfig(total_steps=12, checkpoint_every=3,
                            checkpoint_dir=str(tmp_path / "faulty"), async_checkpoint=False)
        out = Trainer(_toy_step, pipe.make_batch, _state0(), cfg, fault_hook=fault_hook).run()
        assert out["events"].restarts == 2
        assert torch.equal(out["state"][0]["w"], ref["state"][0]["w"])
        assert int(out["state"][1]) == int(ref["state"][1]) == 12

    def test_resume_after_preemption(self, tmp_path):
        pipe = self._pipeline()
        cfg = TrainerConfig(total_steps=12, checkpoint_every=2, checkpoint_dir=str(tmp_path),
                            async_checkpoint=False)
        t1 = Trainer(_toy_step, pipe.make_batch, _state0(), cfg)
        orig = t1.step_fn

        def stopping_step(state, batch):
            out = orig(state, batch)
            if int(out[0][1]) >= 6:
                t1.request_stop()
            return out

        t1.step_fn = stopping_step
        t1.run()
        t2 = Trainer(_toy_step, pipe.make_batch, _state0(), cfg)
        assert t2.start_step >= 6
        assert t2.run()["final_step"] == 12

    def test_straggler_detection(self, tmp_path):
        fake = {"t": 0.0, "step": 0, "phase": 0}

        def fake_clock():  # twice a step; step 9 "takes" 100× the median
            if fake["phase"] == 0:
                fake["phase"] = 1
            else:
                fake["phase"] = 0
                fake["t"] += 1.0 if fake["step"] == 9 else 0.01
                fake["step"] += 1
            return fake["t"]

        cfg = TrainerConfig(total_steps=12, checkpoint_every=100, checkpoint_dir=str(tmp_path),
                            async_checkpoint=False, straggler_factor=3.0)
        out = Trainer(_toy_step, self._pipeline().make_batch, _state0(), cfg,
                      time_fn=fake_clock).run()
        assert out["events"].stragglers >= 1
        assert any("straggler" in line for line in out["events"].log)

    def test_data_pipeline_deterministic(self):
        pipe = self._pipeline()
        b1, b2, b3 = pipe.make_batch(7), pipe.make_batch(7), pipe.make_batch(8)
        np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
        assert not np.array_equal(b1["tokens"], b3["tokens"])


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "mamba2-1.3b"])
def test_grad_step(arch):
    cfg = tsmoke(arch)
    params = params_dict(tmodels.init(torch.Generator().manual_seed(0), cfg, device="cpu"))
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)),
             "labels": rng.integers(0, cfg.vocab_size, (B, S))}
    loss, _, grads = loss_and_grads(cfg, params, batch)
    assert np.isfinite(float(loss))
    assert all(bool(torch.isfinite(g).all()) for g in grads.values())
    assert any(float(g.abs().max()) > 0 for g in grads.values())
