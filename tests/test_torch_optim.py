"""The Hessian-free optimizer of the PyTorch port against the live JAX reference.

``tests/test_optim.py``'s teacher-student problem (64 samples, tanh
outputs) with dict parameters inserted in unsorted key order, so the
port's sorted ravel is what lines the carried basis up.  The reference's
``hf_init`` bootstrap basis crosses into the port through
``convert.hf_state_from_numpy``; then both packages take the same steps.
At solver tol 1e-10 (k = 4, ℓ = 8) every step matches in both modes,
``solver="ggn"`` (def-CG on the damped GGN) and ``"gauss_newton"``
((def)LSMR on the Jacobian): loss to 1e-10 relative, the float32 LM
damping and the accepted flag exactly, solver iterations and matvecs
exactly.  ``TestHessianFree``'s three claims are held by the port on its
own bootstrap (a ``torch.Generator``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.optim as jo  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import optim as to  # noqa: E402
from repro_torch.core import pytree as tpt  # noqa: E402

STEPS = 6


def _problem(seed=0, bias=True):
    """``tests/test_optim.py:_problem`` as numpy; ``bias`` adds a second
    leaf ("b", inserted after "w", so key order is not sorted order)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((64, 8))
    y = np.tanh(x @ rng.standard_normal((8, 3)))
    params = {"w": rng.standard_normal((8, 3)) * 0.1}
    if bias:
        params["b"] = np.full(3, 0.05)
    return x, y, params


def _torch_fns():
    def model_fn(p, batch):
        out = batch["x"] @ p["w"]
        return torch.tanh(out + p["b"] if "b" in p else out)

    def loss_fn(outputs, batch):
        return torch.mean(torch.square(outputs - batch["y"]))

    def residual_fn(p, batch):
        return model_fn(p, batch) - batch["y"]

    return model_fn, loss_fn, residual_fn


def _jax_fns():
    def model_fn(p, batch):
        out = batch["x"] @ p["w"]
        return jnp.tanh(out + p["b"] if "b" in p else out)

    def loss_fn(outputs, batch):
        return jnp.mean(jnp.square(outputs - batch["y"]))

    def residual_fn(p, batch):
        return model_fn(p, batch) - batch["y"]

    return model_fn, loss_fn, residual_fn


def _step(lib, fns, params, state, batch, cfg):
    model_fn, loss_fn, residual_fn = fns
    if cfg.solver == "gauss_newton":
        return lib.hf_step(params, state, batch, residual_fn=residual_fn, cfg=cfg)
    return lib.hf_step(params, state, batch, model_fn=model_fn, loss_fn=loss_fn,
                       loss_hvp=lib.squared_loss_hvp, cfg=cfg)


def _state_to_numpy(js):
    r = js.recycle
    return dict(
        recycle={"W": r.W, "AW": r.AW, "theta": r.theta,
                 "systems_solved": r.systems_solved, "drift": r.drift},
        delta_prev={k: np.asarray(v) for k, v in js.delta_prev.items()},
        damping=js.damping, step=js.step, last_cg_iters=js.last_cg_iters,
    )


@pytest.mark.parametrize("recycle", [True, False], ids=["recycle", "cold"])
@pytest.mark.parametrize("solver", ["ggn", "gauss_newton"])
def test_hf_step_matches_reference(solver, recycle):
    x, y, p0 = _problem()
    kw = dict(k=4, ell=8, cg_maxiter=200, cg_tol=1e-10, init_damping=0.1,
              solver=solver, recycle=recycle)
    jcfg, tcfg = jo.HFConfig(**kw), to.HFConfig(**kw)
    jb = {"x": jnp.asarray(x), "y": jnp.asarray(y)}
    tb = {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v) for k, v in p0.items()}
    js = jo.hf_init(jp, jcfg, jax.random.PRNGKey(0))
    ts = convert.hf_state_from_numpy(**_state_to_numpy(js), dtype=torch.float64, device="cpu")
    assert ts.damping.dtype == torch.float32 and ts.step.dtype == torch.int32
    jfns, tfns = _jax_fns(), _torch_fns()
    for i in range(STEPS):
        jp, js, jm = _step(jo, jfns, jp, js, jb, jcfg)
        tp, ts, tm = _step(to, tfns, tp, ts, tb, tcfg)
        what = f"{solver} step {i}"
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-10, err_msg=what)
        np.testing.assert_allclose(float(tm["new_loss"]), float(jm["new_loss"]), rtol=1e-10,
                                   err_msg=what)
        assert tm["damping"].dtype == torch.float32
        assert float(tm["damping"]) == float(jm["damping"]), what
        assert bool(tm["accepted"]) == bool(jm["accepted"]), what
        assert int(tm["cg_iterations"]) == int(jm["cg_iterations"]), what
        assert int(tm["cg_matvecs"]) == int(jm["cg_matvecs"]), what
    for key in p0:
        np.testing.assert_allclose(tp[key].numpy(), np.asarray(jp[key]), atol=1e-10)
    back = convert.hf_state_to_numpy(ts)
    np.testing.assert_allclose(tpt.ravel({k: torch.from_numpy(v) for k, v in
                                          back["delta_prev"].items()}).numpy(),
                               np.asarray(jax.flatten_util.ravel_pytree(js.delta_prev)[0]),
                               atol=1e-8)
    assert int(back["step"]) == STEPS
    if recycle:
        assert int(back["recycle"]["systems_solved"]) == STEPS


def test_hf_init_and_state_round_trip():
    _, _, p0 = _problem()
    params = {k: torch.from_numpy(v) for k, v in p0.items()}
    cfg = to.HFConfig(k=4)
    state = to.hf_init(params, cfg, torch.Generator().manual_seed(0))
    W = state.recycle.W
    assert tuple(W.shape) == (4, 27) and W.dtype == torch.float64
    torch.testing.assert_close(W @ W.T, torch.eye(4, dtype=torch.float64), atol=1e-12, rtol=0)
    assert state.damping.dtype == torch.float32 and float(state.damping) == np.float32(1.0)
    assert set(state.delta_prev) == {"w", "b"}
    back = convert.hf_state_from_numpy(**convert.hf_state_to_numpy(state),
                                       dtype=torch.float64, device="cpu")
    assert torch.equal(back.recycle.W, W)
    assert torch.equal(back.delta_prev["w"], state.delta_prev["w"])
    with pytest.raises(ValueError, match="solver"):
        to.HFConfig(solver="adam")
    with pytest.raises(ValueError, match="residual_fn"):
        to.hf_step(params, state, {}, cfg=to.HFConfig(solver="gauss_newton"))


def test_softmax_xent_hvp_matches_reference():
    rng = np.random.default_rng(1)
    logits, tangent = rng.standard_normal((2, 5, 7)), rng.standard_normal((2, 5, 7))
    want = jo.softmax_xent_hvp(jnp.asarray(logits), jnp.asarray(tangent))
    got = to.softmax_xent_hvp(torch.from_numpy(logits), torch.from_numpy(tangent))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# tests/test_optim.py's TestHessianFree claims, held by the port
# ---------------------------------------------------------------------------


def _run_port(seed, cfg, steps, generator_seed=0):
    x, y, p0 = _problem(seed, bias=False)
    batch = {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}
    params = {k: torch.from_numpy(v) for k, v in p0.items()}
    state = to.hf_init(params, cfg, torch.Generator().manual_seed(generator_seed))
    fns = _torch_fns()
    metrics = []
    for _ in range(steps):
        params, state, m = _step(to, fns, params, state, batch, cfg)
        metrics.append(m)
    return params, metrics, batch


@pytest.mark.parametrize("solver", ["ggn", "gauss_newton"])
def test_hf_reduces_loss(solver):
    cfg = to.HFConfig(k=4, ell=8, cg_maxiter=30, init_damping=0.1, solver=solver)
    _, metrics, _ = _run_port(0, cfg, 12)
    losses = [float(m["loss"]) for m in metrics]
    assert all(np.isfinite(losses))
    assert losses[-1] < 0.05 * losses[0]


@pytest.mark.parametrize("solver", ["ggn", "gauss_newton"])
def test_hf_beats_gd_per_step(solver):
    cfg = to.HFConfig(k=4, ell=8, cg_maxiter=30, init_damping=0.1, solver=solver)
    _, metrics, batch = _run_port(3, cfg, 12)
    model_fn, loss_fn, _ = _torch_fns()

    def loss(p):
        return loss_fn(model_fn(p, batch), batch)

    _, _, p0 = _problem(3, bias=False)
    params = {k: torch.from_numpy(v) for k, v in p0.items()}
    for _ in range(12):
        grads = torch.func.grad(loss)(params)
        params = {k: params[k] - 0.5 * grads[k] for k in params}
    hf_new = metrics[-1]["new_loss"]
    if solver == "gauss_newton":  # its loss is ½‖r‖², not the mean square
        hf_new = 2.0 * hf_new / batch["y"].numel()
    assert float(hf_new) < float(loss(params))


def test_recycling_reduces_cg_iterations():
    """Later HF steps need no more def-CG iterations with recycling than
    the no-recycle baseline: the paper's claim on a GGN sequence."""
    totals = {}
    for recycle in (True, False):
        cfg = to.HFConfig(k=4, ell=8, cg_maxiter=200, cg_tol=1e-6, init_damping=0.1,
                          recycle=recycle)
        _, metrics, _ = _run_port(5, cfg, 10, generator_seed=1)
        totals[recycle] = sum(int(m["cg_iterations"]) for m in metrics[2:])
    assert totals[True] <= totals[False]
