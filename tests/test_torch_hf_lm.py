"""The Hessian-free LM example (``examples/hessian_free_lm.py``, the paper
at LM scale) on the PyTorch port against the JAX reference.

Both packages run the example's loop for 3 steps from the same qwen1.5
SMOKE parameters (the reference's, carried over by ``repro_torch.convert``)
and the same ``HFState`` (the reference's bootstrap basis, permuted from
its parameter order into the port's): ``hf_step`` with ``solver="ggn"``
over the LM's logits and the example's own loss, at the example's
settings (batch 4 × seq 32, ``HFConfig(k=4, ell=8, cg_tol=1e-3,
cg_maxiter=50, init_damping=10.0)``, recycled).  Per step: the loss to
1e-4, the CG iterations within one (ROADMAP P1) and the accept decision
equal.  The port's GGN products run K9's plain forward, backward and
forward-mode arms through ``torch.func`` (``jvp``, ``vjp``,
``linearize``); the reference's step is jitted once.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.flatten_util import ravel_pytree

torch = pytest.importorskip("torch")

from repro import models as jmodels  # noqa: E402
from repro.configs import get_smoke_config as jsmoke  # noqa: E402
from repro.data import TokenPipeline  # noqa: E402
from repro.models.layers import lm_head_weights as jhead  # noqa: E402
from repro.optim import HFConfig as JHFConfig  # noqa: E402
from repro.optim import hf_init as jhf_init  # noqa: E402
from repro.optim import hf_step as jhf_step  # noqa: E402
from repro.optim import softmax_xent_hvp as jhvp  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import models as tmodels  # noqa: E402
from repro_torch.configs import get_smoke_config as tsmoke  # noqa: E402
from repro_torch.models.layers import lm_head_weights  # noqa: E402
from repro_torch.optim import HFConfig, hf_step, softmax_xent_hvp  # noqa: E402

ARCH, STEPS = "qwen1.5-0.5b", 3
SETTINGS = dict(k=4, ell=8, cg_tol=1e-3, cg_maxiter=50, init_damping=10.0, recycle=True)


def _reference_run(cfg, params, batches):
    def model_fn(p, batch):
        hidden, _ = jmodels.forward_hidden(p, batch, cfg)
        return hidden @ jhead(p["embed"], cfg)

    def loss_fn(logits, batch):
        labels = batch["labels"]
        lse = jax.nn.logsumexp(logits, axis=-1)
        ll = jnp.take_along_axis(logits, labels[..., None], axis=-1)[..., 0]
        return jnp.mean(lse - ll)

    hcfg = JHFConfig(**SETTINGS)
    state0 = jhf_init(params, hcfg, jax.random.PRNGKey(1))
    step = jax.jit(lambda p, s, b: jhf_step(p, s, b, model_fn=model_fn, loss_fn=loss_fn,
                                            loss_hvp=jhvp, cfg=hcfg))
    state, out = state0, []
    for batch in batches:
        params, state, m = step(params, state, {k: jnp.asarray(v) for k, v in batch.items()})
        out.append({k: np.asarray(m[k]) for k in ("loss", "cg_iterations", "damping",
                                                  "accepted")})
    return state0, out


def _port_state(state0, ref_params, cfg):
    """The reference's initial HFState in the port's parameter order."""
    _, unravel = ravel_pytree(ref_params)

    def flat(vec):
        d = convert.model_state_from_numpy(jax.tree_util.tree_map(np.asarray, unravel(vec)), cfg)
        return np.concatenate([d[k].ravel() for k in sorted(d)])

    rec = state0.recycle
    recycle = {"W": np.stack([flat(w) for w in np.asarray(rec.W)]),
               "AW": np.stack([flat(w) for w in np.asarray(rec.AW)]),
               "theta": rec.theta, "systems_solved": rec.systems_solved, "drift": rec.drift}
    delta = convert.model_state_from_numpy(jax.tree_util.tree_map(np.asarray, state0.delta_prev),
                                           cfg)
    return convert.hf_state_from_numpy(recycle, delta, state0.damping, state0.step,
                                       state0.last_cg_iters, dtype=torch.float32, device="cpu")


def _port_run(cfg, params, state, batches):
    skeleton = tmodels.transformer.Model(None, cfg, "meta")

    def logits(model, batch):
        hidden, _ = tmodels.forward_hidden(model, batch, cfg)
        return hidden @ lm_head_weights(model.embed, cfg)

    def model_fn(p, batch):
        return torch.func.functional_call(skeleton, p, (logits, batch))

    def loss_fn(lg, batch):
        labels = batch["labels"]
        lse = torch.logsumexp(lg, dim=-1)
        return torch.mean(lse - lg.gather(-1, labels[..., None])[..., 0])

    hcfg = HFConfig(**SETTINGS)
    out = []
    for batch in batches:
        params, state, m = hf_step(params, state, convert.train_batch_from_numpy(batch, device="cpu"),
                                   model_fn=model_fn, loss_fn=loss_fn,
                                   loss_hvp=softmax_xent_hvp, cfg=hcfg)
        out.append({k: m[k].numpy() for k in ("loss", "cg_iterations", "damping", "accepted")})
    return out


def test_hessian_free_lm_matches_reference():
    jcfg, tcfg = jsmoke(ARCH), tsmoke(ARCH)
    ref_params = jmodels.init(jax.random.PRNGKey(0), jcfg)
    pipe = TokenPipeline(vocab_size=jcfg.vocab_size, batch=4, seq_len=32)
    batches = [pipe.make_batch(i) for i in range(STEPS)]
    state0, want = _reference_run(jcfg, ref_params, batches)
    params = convert.train_params_from_numpy(jax.tree_util.tree_map(np.asarray, ref_params), tcfg,
                                             device="cpu")
    got = _port_run(tcfg, params, _port_state(state0, ref_params, tcfg), batches)
    for i, (g, w) in enumerate(zip(got, want)):
        assert abs(float(g["loss"]) - float(w["loss"])) <= 1e-4 * abs(float(w["loss"])), i
        assert abs(int(g["cg_iterations"]) - int(w["cg_iterations"])) <= 1, (i, g, w)
        assert bool(g["accepted"]) == bool(w["accepted"]), i
