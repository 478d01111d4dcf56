"""K10's derivative on the CPU: the plain backward and forward-mode arms.

``ssd_bwd_plain`` and ``ssd_jvp_plain`` (``repro_torch.kernels.ssd_scan``)
carry the SSD scan's gradient and tangent through the chunks with the
formulas of the module's comment; they are the CPU path of
:class:`~repro_torch.kernels.ssd_scan.SSDScan` and the card's yardstick
for its CUDA arms.  Here they are held

* against autograd and ``torch.func.jvp`` of ``ssd_plain`` (1e-5 of each
  output's max abs, f32): g > 1, ragged l, a chunk that does not divide l,
  l below the chunk, with and without ``initial_state`` / ``return_state``;
* through ``ops.ssd`` (the D skip included) against ``jax.vjp`` /
  ``jax.jvp`` of the reference's ``ops.ssd(impl="chunked")`` on the same
  numpy inputs: f32 2e-4 and bf16 5e-2 of each output's max abs (the
  reference's chunked scan forms ``C Bᵀ`` in bf16, the port in f32);
* on the route: ``torch.func.grad``, ``vjp``, ``jvp`` and ``linearize``
  through ``ops.ssd`` reach the custom ops and their plain arms, and the
  custom ops pass ``torch.library.opcheck``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ssd_scan as ss  # noqa: E402

# b, l, h, p, g, n, chunk
CASES = [
    (1, 64, 2, 16, 1, 16, 32),   # whole chunks
    (2, 100, 4, 8, 2, 24, 32),   # g = 2, a ragged last chunk
    (1, 37, 2, 4, 2, 8, 16),     # ragged, g = h
    (2, 20, 2, 8, 1, 16, 32),    # l below the chunk
]
NAMES = ("x", "dt", "a", "bmat", "cmat", "h0")


def _inputs(case, seed=0):
    b, l, h, p, g, n, _ = case
    rng = np.random.default_rng(sum(case) + seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"x": f(b, l, h, p), "dt": rng.uniform(0.01, 0.4, (b, l, h)).astype(np.float32),
            "a": (-rng.uniform(0.3, 2.0, (h,))).astype(np.float32), "bmat": f(b, l, g, n),
            "cmat": f(b, l, g, n), "d": f(h), "h0": f(b, h, p, n), "dy": f(b, l, h, p),
            "dh": f(b, h, p, n), "tx": f(b, l, h, p), "tdt": 0.1 * f(b, l, h), "ta": 0.1 * f(h),
            "tbmat": f(b, l, g, n), "tcmat": f(b, l, g, n), "th0": f(b, h, p, n)}


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("state", [False, True])
def test_plain_arms_match_autograd_of_ssd_plain(case, state):
    arr = {k: torch.as_tensor(v) for k, v in _inputs(case).items()}
    chunk = case[-1]
    ins = [arr[k] for k in NAMES[:5]] + ([arr["h0"]] if state else [])

    def f(*t):
        return ss.ssd_plain(*t[:5], chunk=chunk, initial_state=t[5] if state else None,
                            return_state=True)

    (y, h1), vjp = torch.func.vjp(f, *ins)
    want = vjp((arr["dy"], arr["dh"]))
    h0 = arr["h0"] if state else None
    y2, h2, hs, cs = ss.ssd_fwd_plain(*ins[:5], h0, chunk=chunk)
    assert torch.equal(y2, y) and torch.equal(h2, h1)
    assert hs.shape == (*case[:2][:1], case[2], -(-case[1] // min(chunk, case[1])), case[3],
                        case[5])
    got = ss.ssd_bwd_plain(arr["dy"], *ins[:5], h0, hs, cs, arr["dh"], chunk=chunk)
    for name, g, w in zip(NAMES, got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        assert _rel(g, w) <= 1e-5, (name, _rel(g, w))
    tans = [arr[k] for k in ("tx", "tdt", "ta", "tbmat", "tcmat")] + (
        [arr["th0"]] if state else [])
    _, (ty, th) = torch.func.jvp(f, tuple(ins), tuple(tans))
    gy, gh = ss.ssd_jvp_plain(*ins[:5], h0, hs, cs, *tans[:5], arr["th0"] if state else None,
                              chunk=chunk)
    assert _rel(gy, ty) <= 1e-5 and _rel(gh, th) <= 1e-5


def _ref_maps(case, dname, state):
    """The reference's and the port's ``ops.ssd`` as functions of the
    differentiated inputs, with the numpy inputs in each package."""
    arr = _inputs(case, seed=1)
    chunk = case[-1]
    low = ("x", "bmat", "cmat", "tx", "tbmat", "tcmat")
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dname]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dname]
    jarr = {k: jnp.asarray(v, jdt if k in low else jnp.float32) for k, v in arr.items()}
    tarr = {k: torch.as_tensor(v).to(tdt if k in low else torch.float32) for k, v in arr.items()}
    keys = list(NAMES[:5]) + ["d"] + (["h0"] if state else [])

    def jf(*t):
        kw = dict(initial_state=t[6]) if state else {}
        return jops.ssd(*t[:6], impl="chunked", chunk=chunk, return_state=True, **kw)

    def tf(*t):
        return tops.ssd(*t[:6], chunk=chunk, initial_state=t[6] if state else None,
                        return_state=True)

    return jarr, tarr, keys, jf, tf


@pytest.mark.parametrize("case", CASES[1:3])
@pytest.mark.parametrize("dname, bar", [("float32", 2e-4), ("bfloat16", 5e-2)])
@pytest.mark.parametrize("state", [False, True])
def test_arms_through_ops_match_the_reference(case, dname, bar, state):
    """``y + x·d`` is f32 in both packages, so its cotangent is f32."""
    jarr, tarr, keys, jf, tf = _ref_maps(case, dname, state)
    tkeys = ["tx", "tdt", "ta", "tbmat", "tcmat", "d"] + (["th0"] if state else [])
    jins, tins = [jarr[k] for k in keys], [tarr[k] for k in keys]
    jg, (jty, jth) = jax.jit(lambda ins, ct, tans: (
        jax.vjp(jf, *ins)[1](ct), jax.jvp(jf, tuple(ins), tuple(tans))[1]))(
        jins, (jarr["dy"], jarr["dh"]), [jarr[k] for k in tkeys])
    (ty, th), tvjp_fn = torch.func.vjp(tf, *tins)
    assert ty.dtype == torch.float32
    tg = tvjp_fn((tarr["dy"], tarr["dh"]))
    for name, g, w in zip(keys, tg, jg):
        assert g.dtype == tarr[name].dtype, name
        assert _rel(g.float(), np.asarray(w, np.float32)) <= bar, (name, _rel(g.float(), w))
    _, (tty, tth) = torch.func.jvp(tf, tuple(tins), tuple(tarr[k] for k in tkeys))
    assert _rel(tty.float(), np.asarray(jty, np.float32)) <= bar
    assert _rel(tth, np.asarray(jth, np.float32)) <= bar


def test_ops_ssd_routes_derivatives_through_the_arms(monkeypatch):
    case = CASES[1]
    arr = {k: torch.as_tensor(v) for k, v in _inputs(case).items()}
    x, dt, a, bm, cm, d = (arr[k] for k in ("x", "dt", "a", "bmat", "cmat", "d"))
    seen = []
    for name in ("ssd_fwd_plain", "ssd_bwd_plain", "ssd_jvp_plain"):
        fn = getattr(ss, name)
        monkeypatch.setattr(ss, name, lambda *t, _fn=fn, _n=name, **k: (seen.append(_n),
                                                                        _fn(*t, **k))[1])

    def f(x, dt, a, bm, cm):
        return tops.ssd(x, dt, a, bm, cm, d, chunk=32)

    want = ss.ssd_plain(x, dt, a, bm, cm, d, chunk=32)
    g = torch.func.grad(lambda *t: f(*t).square().sum(), argnums=(0, 1, 2, 3, 4))(
        x, dt, a, bm, cm)
    assert seen == ["ssd_fwd_plain", "ssd_bwd_plain"] and len(g) == 5
    seen.clear()
    ins = (x, dt, a, bm, cm)
    tans = tuple(torch.ones_like(t) for t in ins)
    y, lin = torch.func.linearize(f, *ins)
    assert torch.equal(y, want)
    assert "ssd_jvp_plain" in seen  # the tangent map is traced through the jvp arm
    seen.clear()
    jv = torch.func.jvp(f, ins, tans)[1]
    assert seen == ["ssd_fwd_plain", "ssd_jvp_plain"]
    assert torch.equal(lin(*tans), jv)
    seen.clear()
    leaves = [t.clone().requires_grad_(True) for t in ins]
    f(*leaves).sum().backward()
    assert seen == ["ssd_fwd_plain", "ssd_bwd_plain"]
    assert all(t.grad is not None for t in leaves)
    # Not differentiated: the serving arm, as before; the reference by autograd.
    seen.clear()
    with torch.no_grad():
        assert torch.equal(f(*leaves), want) and seen == []
    ref = tops.ssd(*leaves, d, backend="reference")
    assert ref.grad_fn is not None and seen == []


def test_the_custom_ops_pass_opcheck():
    case = CASES[2]
    arr = {k: torch.as_tensor(v) for k, v in _inputs(case).items()}
    x, dt, a, bm, cm, h0 = (arr[k] for k in NAMES)
    chunk = case[-1]
    torch.library.opcheck(ss._fwd_op, (x, dt, a, bm, cm, h0, chunk, False))
    _, _, hs, cs = ss.ssd_fwd_plain(x, dt, a, bm, cm, h0, chunk=chunk)
    torch.library.opcheck(ss._bwd_op, (arr["dy"], x, dt, a, bm, cm, h0, hs, cs, arr["dh"],
                                       chunk, False))
    torch.library.opcheck(ss._jvp_op, (x, dt, a, bm, cm, None, hs, cs, arr["tx"], arr["tdt"],
                                       arr["ta"], arr["tbmat"], arr["tcmat"], None, chunk, False))
