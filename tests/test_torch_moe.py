"""The MoE layer of the PyTorch port against the JAX reference.

``repro_torch.models.moe``'s two dispatchers (``moe_apply_grouped``, the
default, and ``moe_apply_global``) against ``repro.models.moe``'s on the
same numpy inputs and the reference's own parameters (``moe_init``),
dropless (capacity factor 8) and dropping (1.0 and 0.5), SwiGLU and GELU
experts:

* routing: the expert ids the port records equal the reference's top-k of
  its f32 router (``jax.lax.top_k`` of ``jax.nn.softmax``, the reference's
  own lines) and the kept masks equal the reference's position rule (a
  stable sort by expert, token-major), exactly, in f64 and f32;
* f64: the output within 1e-6 of its scale of the reference's and the aux
  loss within 1e-6 relative.  Both packages round the router's softmax and
  the experts' activations through f32, as the reference's cast points
  say, and XLA's and PyTorch's f32 ``exp`` differ by an ulp (ROADMAP P12),
  so nothing past those casts can agree to 1e-12.  What the port computes
  from them is held to 1e-12 instead: the output against a per-token
  oracle in PyTorch (each kept assignment's expert on its own row, at the
  same cast points), which checks capacity, dispatch and combine;
* f32: the output to 2e-4 and the aux loss to 1e-5 relative;
* gradients of the output (against a fixed cotangent) plus the aux loss
  with respect to the input and every parameter, against ``jax.grad`` of
  the reference, at 2e-4 of each leaf's max abs (f32);
* two backward passes bit for bit, and a replayed routing
  (``replay_routing``) reproducing a run bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_smoke_config as jsmoke  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402

B, S = 2, 48
JDT = {"float64": jnp.float64, "float32": jnp.float32}
TDT = {"float64": torch.float64, "float32": torch.float32}
CASES = [(dispatch, mlp, cf) for dispatch in ("grouped", "global")
         for mlp in ("swiglu", "gelu") for cf in (8.0, 1.0, 0.5)]


def _cfgs(dispatch, mlp, cf, dtype):
    jcfg = dataclasses.replace(jsmoke("olmoe-1b-7b"), moe_dispatch=dispatch, mlp_type=mlp,
                               capacity_factor=cf, dtype=dtype)
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


def _setup(dispatch, mlp, cf, dtype, seed=0):
    jcfg, tcfg = _cfgs(dispatch, mlp, cf, dtype)
    jparams = jmoe.moe_init(jax.random.PRNGKey(seed), jcfg)
    jparams = jax.tree_util.tree_map(lambda a: a.astype(JDT[dtype]), jparams)
    layer = tmoe.MoE(torch.Generator().manual_seed(0), tcfg, "cpu")
    layer.load_state_dict({convert._port_leaf(k, "moe"): torch.as_tensor(np.array(v))
                           for k, v in jparams.items()}, assign=True)
    x = np.random.default_rng(seed + 1).standard_normal((B, S, jcfg.d_model))
    return jcfg, tcfg, jparams, layer, x.astype(np.float64 if dtype == "float64" else np.float32)


def _ref_apply(jcfg):
    return jmoe.moe_apply_grouped if jcfg.moe_dispatch == "grouped" else jmoe.moe_apply_global


def _port_apply(tcfg):
    return tmoe.moe_apply_grouped if tcfg.moe_dispatch == "grouped" else tmoe.moe_apply_global


def _ref_routing(jcfg, jparams, x):
    """The reference's expert ids (its router lines) and kept masks (its
    position rule, in numpy), (B, S, k) each."""
    k, e = jcfg.experts_per_token, jcfg.n_experts
    xj = jnp.asarray(x)
    logits = (xj @ jparams["router"].astype(xj.dtype)).astype(jnp.float32)
    _, eidx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), k)
    eidx = np.asarray(eidx)
    if jcfg.moe_dispatch == "grouped":
        groups, cap = eidx.reshape(B, S * k), max(int(S * k / e * jcfg.capacity_factor), k)
    else:
        groups, cap = eidx.reshape(1, B * S * k), jmoe.capacity(jcfg, B * S)
    keep = np.zeros(groups.shape, bool)
    for g, row in enumerate(groups):
        seen = np.zeros(e, int)
        for a, ex in enumerate(row):  # token-major order, stable per expert
            keep[g, a] = seen[ex] < cap
            seen[ex] += 1
    return eidx, keep.reshape(B, S, k)


def _oracle(layer, tcfg, x, routing):
    """Each kept assignment's expert on its token's row alone, gate-weighted
    and summed over the token's choices in order, at the port's cast points
    (gates and activations through f32)."""
    xt = torch.as_tensor(x)
    dt = xt.dtype
    probs = torch.softmax((xt @ layer.router.to(dt)).float(), dim=-1)
    eidx, kept = routing.experts, routing.kept
    gates = torch.gather(probs, -1, eidx)
    gates = gates / torch.clamp(gates.sum(dim=-1, keepdim=True), min=1e-9)
    out = torch.zeros_like(xt)
    for b in range(B):
        for t in range(S):
            row = xt[b, t][None]
            acc = None
            for j in range(tcfg.experts_per_token):
                ex = int(eidx[b, t, j])
                if tcfg.mlp_type == "swiglu":
                    h = (torch.nn.functional.silu((row @ layer.gate[ex]).float()).to(dt)
                         * (row @ layer.up[ex]))
                else:
                    h = torch.nn.functional.gelu((row @ layer.up[ex]).float(),
                                                 approximate="tanh").to(dt)
                y = (h @ layer.down[ex])[0] * gates[b, t, j].to(dt) * float(kept[b, t, j])
                acc = y if acc is None else acc + y
            out[b, t] = acc
    return out


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("dispatch,mlp,cf", CASES)
def test_moe_matches_reference(dispatch, mlp, cf, dtype):
    jcfg, tcfg, jparams, layer, x = _setup(dispatch, mlp, cf, dtype)
    want, jaux = _ref_apply(jcfg)(jparams, jnp.asarray(x), jcfg)
    with tmoe.record_routing() as rec:
        got, aux = _port_apply(tcfg)(layer, torch.as_tensor(x), tcfg)
    (routing,) = rec
    eidx, keep = _ref_routing(jcfg, jparams, x)
    np.testing.assert_array_equal(routing.experts.numpy(), eidx)
    np.testing.assert_array_equal(routing.kept.numpy(), keep)
    assert keep.all() == (cf == 8.0)  # the dropping cases drop
    assert got.dtype == TDT[dtype] and got.shape == x.shape and aux.dtype == torch.float32
    want = np.asarray(want)
    scale = np.abs(want).max()
    if dtype == "float64":
        assert np.abs(got.numpy() - want).max() <= 1e-6 * scale
        assert abs(float(aux) - float(jaux)) <= 1e-6 * abs(float(jaux))
        oracle = _oracle(layer, tcfg, x, routing).numpy()
        assert np.abs(got.numpy() - oracle).max() <= 1e-12 * scale
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4 * scale)
        assert abs(float(aux) - float(jaux)) <= 1e-5 * abs(float(jaux))


@pytest.mark.parametrize("dispatch,mlp,cf", [c for c in CASES if c[2] != 0.5])
def test_moe_gradients_match_reference(dispatch, mlp, cf):
    jcfg, tcfg, jparams, layer, x = _setup(dispatch, mlp, cf, "float32", seed=2)
    cot = np.random.default_rng(7).standard_normal(x.shape).astype(np.float32)
    apply = _ref_apply(jcfg)

    def jloss(p, xx):
        y, aux = apply(p, xx, jcfg)
        return jnp.sum(y * cot) + aux

    jg_p, jg_x = jax.grad(jloss, argnums=(0, 1))(jparams, jnp.asarray(x))
    layer.requires_grad_(True)
    xt = torch.as_tensor(x).requires_grad_(True)
    y, aux = _port_apply(tcfg)(layer, xt, tcfg)
    names = [n for n, _ in layer.named_parameters()]
    grads = torch.autograd.grad((y * torch.as_tensor(cot)).sum() + aux,
                                [xt, *layer.parameters()])
    want = [np.asarray(jg_x)] + [np.asarray(jg_p[convert._ref_leaf(n, "moe")]) for n in names]
    for name, g, w in zip(["x"] + names, grads, want):
        scale = np.abs(w).max()
        assert scale > 0, name
        assert np.abs(g.numpy() - w).max() <= 2e-4 * scale, name


@pytest.mark.parametrize("dispatch", ["grouped", "global"])
def test_moe_backward_and_replay_repeat_bit_for_bit(dispatch):
    _, tcfg, _, layer, x = _setup(dispatch, "swiglu", 0.5, "float32", seed=3)
    layer.requires_grad_(True)

    def run():
        xt = torch.as_tensor(x).requires_grad_(True)
        with tmoe.record_routing() as rec:
            y, aux = _port_apply(tcfg)(layer, xt, tcfg)
        grads = torch.autograd.grad(y.square().sum() + aux, [xt, *layer.parameters()])
        return y, grads, rec

    (y1, g1, rec), (y2, g2, _) = run(), run()
    assert torch.equal(y1, y2) and all(torch.equal(a, b) for a, b in zip(g1, g2))
    with torch.no_grad(), tmoe.replay_routing(rec):
        y3, _ = _port_apply(tcfg)(layer, torch.as_tensor(x), tcfg)
    assert torch.equal(y1.detach(), y3)
    # Another input replaying the first one's ids routes its tokens there.
    with torch.no_grad(), tmoe.replay_routing(rec), tmoe.record_routing() as rec2:
        _port_apply(tcfg)(layer, torch.as_tensor(-x), tcfg)
    assert torch.equal(rec2[0].experts, rec[0].experts)


@pytest.mark.parametrize("dispatch", ["grouped", "global"])
def test_moe_forward_mode_is_the_adjoint_of_its_backward(dispatch):
    """``GatherRows``' forward-mode rule (``torch.func.jvp``, as the
    Hessian-free optimizer's products take it) against its backward:
    ⟨J t, c⟩ = ⟨t, Jᵀ c⟩ for the layer's output as a function of its input,
    at f64 and a fixed routing, to 1e-6 relative: the gates' derivative
    runs through the f32 router (P12)."""
    _, tcfg, _, layer, x = _setup(dispatch, "swiglu", 0.5, "float64", seed=4)
    rng = np.random.default_rng(9)
    t, c = (torch.as_tensor(rng.standard_normal(x.shape)) for _ in range(2))
    xt = torch.as_tensor(x)
    with torch.no_grad(), tmoe.record_routing() as rec:
        _port_apply(tcfg)(layer, xt, tcfg)

    def f(xx):
        with tmoe.replay_routing(rec):
            return _port_apply(tcfg)(layer, xx, tcfg)[0]

    _, jt = torch.func.jvp(f, (xt,), (t,))
    _, vjp = torch.func.vjp(f, xt)
    (jtc,) = vjp(c)
    lhs, rhs = float((jt * c).sum()), float((t * jtc).sum())
    assert abs(lhs - rhs) <= 1e-6 * max(abs(lhs), 1.0)
