"""The port's dry-run (``repro_torch.launch``: ``steps.input_specs`` /
``decode_state_specs``, ``trace_stats``, ``roofline``, ``gpc_dryrun``,
``dryrun``) against the JAX reference, on the CPU.

* the cells' inputs: shapes and dtypes equal to the reference's
  (``jax.eval_shape``) for every arch × applicable shape at SMOKE width,
  and for qwen1.5-0.5b and seamless-m4t-large-v2 at full width; the skip
  rules skip the same cells; ``model_flops`` equal for every cell and the
  GPC cell;
* the GPC iteration's seven outputs against the reference's to 1e-10
  relative in f64 (on a one-device ``jax.sharding.Mesh``: ``jax.make_mesh``
  fails under jax 0.9.0), at n a multiple of the reference's row block
  (its Gram product drops the rows past the last whole block: ROADMAP R6);
* ``roofline_terms`` equal to the reference's on its own test records
  (``tests/test_launch.py``), its constants passed in as ``peaks``;
* the kernels' FLOP formulas equal to the ``*_work`` counts behind
  ``PERF.md`` §6's bounds, at its shapes, and the traced bytes to theirs;
* remat lowers the traced peak; a SMOKE dry-run of every cell ends ``ok``
  or ``skipped`` with the reference's reason, the kernels' custom ops in
  its census.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import models as jmodels  # noqa: E402
from repro.configs import gpc_mnist as j_gpc_cfg  # noqa: E402
from repro.configs import registry as jregistry  # noqa: E402
from repro.launch import gpc_dryrun as j_gpc  # noqa: E402
from repro.launch import roofline as j_roofline  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro_torch.configs import gpc_mnist, registry  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import rbf_matvec as rbf  # noqa: E402
from repro_torch.kernels import ssd_scan as ss  # noqa: E402
from repro_torch.kernels import work  # noqa: E402
from repro_torch.launch import dryrun, gpc_dryrun, roofline, steps, trace_stats  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

CELLS = [(arch, name) for arch in registry.ARCH_IDS for name in registry.SHAPES]


def _dtype(x) -> str:
    return str(x).split(".")[-1] if isinstance(x, torch.dtype) else jnp.dtype(x).name


def _same(port: torch.Tensor, ref, lead: int = 0) -> None:
    assert tuple(port.shape) == tuple(ref.shape[lead:]), (port.shape, ref.shape)
    assert _dtype(port.dtype) == _dtype(ref.dtype)


def _state_leaves(state) -> list:
    return [leaf for leaf in state if isinstance(leaf, torch.Tensor)]


def _check_specs(arch: str, smoke: bool) -> None:
    get = "get_smoke_config" if smoke else "get_config"
    cfg, jcfg = getattr(registry, get)(arch), getattr(jregistry, get)(arch)
    for name, shape in registry.SHAPES.items():
        jshape = jregistry.SHAPES[name]
        ok, why = registry.shape_applicable(cfg, shape)
        assert (ok, why) == jregistry.shape_applicable(jcfg, jshape)
        assert steps.model_flops(cfg, shape) == jsteps.model_flops(jcfg, jshape)
        if not ok:
            continue
        batch, jbatch = steps.input_specs(cfg, shape), jsteps.input_specs(jcfg, jshape)
        assert sorted(batch) == sorted(jbatch)
        for key in batch:
            _same(batch[key], jbatch[key])
            assert batch[key].device.type == "meta"
        if shape.kind != "decode":
            continue
        state = steps.decode_state_specs(cfg, shape)
        if jcfg.is_encdec:
            params = jax.eval_shape(lambda k: jmodels.init(k, jcfg),
                                    jax.ShapeDtypeStruct((2,), jnp.uint32))
            jstate = jax.eval_shape(jsteps.decode_state_specs(jcfg, jshape)[1], params)
        else:
            jstate = jsteps.decode_state_specs(jcfg, jshape)[0]
        # The reference stacks each slot of a period over the periods.
        period = cfg.period()
        assert len(state.caches) == cfg.n_layers
        for i, cache in enumerate(state.caches):
            jleaves = [x for x in jstate.caches[i % period] if x.ndim > 1]
            for leaf, jleaf in zip(_state_leaves(cache), jleaves, strict=True):
                assert jleaf.shape[0] == cfg.n_layers // period
                _same(leaf, jleaf, lead=1)
        if cfg.is_encdec:
            for i, kv in enumerate(state.memory):
                for leaf, jleaf in zip(kv, jstate.memory[i % period], strict=True):
                    _same(leaf, jleaf, lead=1)
        else:
            assert state.memory is None and jstate.memory is None


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_specs_match_reference_smoke(arch):
    _check_specs(arch, smoke=True)


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "seamless-m4t-large-v2"])
def test_specs_match_reference_full_width(arch):
    _check_specs(arch, smoke=False)


def test_gpc_model_flops_and_config():
    assert dataclasses.asdict(gpc_mnist.CONFIG) == dataclasses.asdict(j_gpc_cfg.CONFIG)
    assert dataclasses.asdict(gpc_mnist.SMOKE) == dataclasses.asdict(j_gpc_cfg.SMOKE)
    for port_cfg, ref_cfg in ((gpc_mnist.CONFIG, j_gpc_cfg.CONFIG),
                              (gpc_mnist.SMOKE, j_gpc_cfg.SMOKE)):
        assert gpc_dryrun.model_flops(port_cfg) == j_gpc.model_flops(ref_cfg)


def _gpc_inputs(n, d, k, seed=0):
    rng = np.random.default_rng(seed)
    x = 0.05 * rng.random((n, d))  # pre-scaled: distances of order one
    sqrt_h = np.sqrt(rng.uniform(0.05, 0.25, n))
    r, p, xv = (rng.standard_normal(n) for _ in range(3))
    w = np.linalg.qr(rng.standard_normal((n, k)))[0].T
    aw = w + 0.1 * rng.standard_normal((k, n))
    waw_inv = np.linalg.inv(w @ aw.T)
    return x, sqrt_h, (xv, r, p, np.float64(r @ r), w, aw, waw_inv)


def test_gpc_iteration_matches_reference():
    cfg = dataclasses.replace(gpc_mnist.SMOKE, n=512, block=128)
    jcfg = dataclasses.replace(j_gpc_cfg.SMOKE, n=512, block=128)
    x, sqrt_h, state = _gpc_inputs(cfg.n, cfg.d, cfg.k)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("rows",))
    want = jax.jit(j_gpc.make_defcg_iteration(jcfg, mesh))(
        jnp.asarray(x), jnp.asarray(sqrt_h), tuple(jnp.asarray(s) for s in state))
    got = gpc_dryrun.make_defcg_iteration(cfg)(
        torch.as_tensor(x), torch.as_tensor(sqrt_h), tuple(torch.as_tensor(s) for s in state))
    for g, w in zip(got, want, strict=True):
        w = np.asarray(w)
        scale = max(np.abs(w).max(), 1e-300)
        assert np.abs(g.numpy() - w).max() / scale <= 1e-10
    assert not np.allclose(np.asarray(want[2]), state[2])  # p moved


def test_gpc_iteration_sharded_matches_one_card():
    """Two gloo ranks (rows sharded, X whole on each, K8's plain version)
    give the one-card iteration's outputs, with one all_gather of v and two
    all-reduces."""
    import torch_sharded_cases as cases

    from repro_torch.launch import run_ranks

    cfg = dataclasses.replace(gpc_mnist.SMOKE, n=512)
    x, sqrt_h, state = _gpc_inputs(cfg.n, cfg.d, cfg.k, seed=1)
    want = gpc_dryrun.make_defcg_iteration(cfg)(
        torch.as_tensor(x), torch.as_tensor(sqrt_h), tuple(torch.as_tensor(s) for s in state))
    got, issued = run_ranks(cases.gpc_iteration_case, 2, backend="gloo", device="cpu",
                            args=(x, sqrt_h, state))
    assert issued == {"all_reduce": 2, "all_gather": 1}
    for g, w in zip(got, want, strict=True):
        w = w.numpy()
        assert np.abs(g - w).max() / max(np.abs(w).max(), 1e-300) <= 1e-12


def test_gpc_cell_traces_k3_with_its_scratch():
    cfg = gpc_mnist.CONFIG
    counts = gpc_dryrun.trace_cell(cfg)
    assert counts["op_census"]["repro_torch.rbf_matvec"] == 1
    n, d = cfg.n, cfg.d
    nbytes, ops = work.rbf_work(n, d, 1, 4)
    assert counts["flops"] >= ops
    x_bytes = n * d * 4
    assert x_bytes == 3_288_334_336  # X alone, f32
    # Past 1 GB of column scratch K3 runs the full grid: row norms and parts.
    pl = rbf.plan(True, n, n, 1, 4, rbf.H100_SMS)
    scratch = sum(4 * int(np.prod(s)) for s in pl["scratch"].values())
    assert not pl["sym"] and scratch >= 2 * n * 4
    assert x_bytes + scratch <= counts["peak_bytes"] <= x_bytes + scratch + 64 * n * 4
    # At chip_smoke.py's n = 131 072 the symmetric mode's column scratch fits.
    small = dataclasses.replace(cfg, n=131072)
    pl = rbf.plan(True, small.n, small.n, 1, 4, rbf.H100_SMS)
    scratch = sum(4 * int(np.prod(s)) for s in pl["scratch"].values())
    assert pl["sym"] and pl["scratch"]["colpart"] == (512, small.n, 1)
    x_bytes = small.n * small.d * 4
    counts = gpc_dryrun.trace_cell(small)
    assert x_bytes + scratch <= counts["peak_bytes"] <= x_bytes + scratch + 64 * small.n * 4


class TestRoofline:
    PEAKS = {"bytes": j_roofline.HBM_BW, "bfloat16_tensor": j_roofline.PEAK_FLOPS,
             "link": j_roofline.LINK_BW}

    def _rec(self, **kw):  # tests/test_launch.py's record
        rec = {
            "status": "ok", "arch": "x", "shape": "train_4k",
            "mesh": "single", "chips": 256,
            "hlo_flops_per_device": 1.97e13,
            "hlo_traffic_bytes_per_device": 81.9e9,
            "collectives": {"all-reduce": {"count": 1, "bytes": 2.5e9}},
            "model_flops": 1.97e13 * 256,
        }
        rec.update(kw)
        return rec

    @pytest.mark.parametrize("kw", [{}, {"hlo_traffic_bytes_per_device": 0.0,
                                         "collectives": {}}])
    def test_terms_equal_reference(self, kw):
        want = j_roofline.roofline_terms(self._rec(**kw))
        got = roofline.roofline_terms(self._rec(**kw), peaks=self.PEAKS)
        assert got.pop("peak") == "bfloat16_tensor"
        assert got == pytest.approx(want)

    def test_skipped(self):
        assert roofline.roofline_terms({"status": "skipped"}) is None
        assert j_roofline.roofline_terms({"status": "skipped"}) is None

    def test_h100_peaks(self):
        one = self._rec(chips=1, collectives={}, hlo_flops_per_device=989e12,
                        hlo_traffic_bytes_per_device=3.35e12 / 2, model_flops=989e12)
        t = roofline.roofline_terms(one)
        assert t["t_compute_s"] == pytest.approx(1.0)
        assert t["t_memory_s"] == pytest.approx(0.5)
        assert t["t_collective_s"] == 0.0 and t["dominant"] == "compute"
        assert t["roofline_fraction"] == pytest.approx(1.0)
        t = roofline.roofline_terms(dict(one, peak="float32"))
        assert t["t_compute_s"] == pytest.approx(989 / 67)


def _counted(fn, *args):
    """``fn(*args)`` under FlopCounterMode and TraceStats: per-op FLOPs,
    total FLOPs and traced bytes."""
    with FlopCounterMode(display=False) as fc:
        _, counts = trace_stats.trace(fn, *args)
    return {str(k): v for k, v in fc.get_flop_counts()["Global"].items()}, counts


def _meta(*shape, dtype=torch.bfloat16, grad=False):
    return torch.empty(shape, dtype=dtype, device="meta", requires_grad=grad)


def test_k9_formulas_are_the_bound_counts():
    b, h, s, dh = 4, 16, 4096, 64  # qwen1.5-0.5b's prefill and training shape
    q, k, v = (_meta(b, h, s, dh) for _ in range(3))
    flops, counts = _counted(lambda: fa.flash_attention_op(q, k, v, causal=True))
    nbytes, ops = work.attn_work(b, h, h, s, s, dh, True, 2)
    assert ops == 137_438_953_472  # 137.4 GFLOP
    assert flops == {"repro_torch.flash_attention": ops}
    assert counts["bytes"] == nbytes and counts["launches"] == 1

    qg, kg, vg = (_meta(b, h, s, dh, grad=True) for _ in range(3))
    with FlopCounterMode(display=False) as fc:
        out = fa.flash_attention_differentiable(qg, kg, vg, causal=True)
        out.backward(torch.empty_like(out))
        torch.func.jvp(lambda t: fa.flash_attention_differentiable(t, k, v, causal=True),
                       (q,), (q,))
    got = {str(key): val for key, val in fc.get_flop_counts()["Global"].items()}
    for arm in ("lse", "bwd", "jvp"):
        want = work.grad_work(b, h, h, s, s, dh, True, 2, arm)[1]
        assert got[f"repro_torch.flash_attention_{arm}"] == want * (2 if arm == "lse" else 1)


def test_k10_formulas_are_the_bound_counts():
    b, l, h, p, g, n, c = 4, 4096, 64, 64, 1, 128, 128  # mamba2-1.3b's prefill
    x, bm, cm = _meta(b, l, h, p), _meta(b, l, g, n), _meta(b, l, g, n)
    dt, a = _meta(b, l, h, dtype=torch.float32), _meta(h, dtype=torch.float32)
    flops, counts = _counted(lambda: ss.ssd_scan_op(x, dt, a, bm, cm, chunk=c))
    nbytes, ops = work.ssd_work(b, l, h, p, g, n, c, 2)
    assert flops == {"repro_torch.ssd_scan": ops}
    assert counts["bytes"] == nbytes

    b, l = 2, 1024  # its training shape
    xg = _meta(b, l, h, p, grad=True)
    bm, cm = _meta(b, l, g, n), _meta(b, l, g, n)
    dt = _meta(b, l, h, dtype=torch.float32)
    with FlopCounterMode(display=False) as fc:
        y, _ = ss.ssd_differentiable(xg, dt, a, bm, cm, chunk=c)
        y.backward(torch.empty_like(y))
        torch.func.jvp(lambda t: ss.ssd_differentiable(t, dt, a, bm, cm, chunk=c)[0],
                       (xg.detach(),), (xg.detach(),))
    got = {str(key): val for key, val in fc.get_flop_counts()["Global"].items()}
    fwd = work.ssd_work(b, l, h, p, g, n, c, 2)[1]
    assert got["repro_torch.ssd_scan_fwd"] == 2 * fwd  # the training forward, then the JVP's
    for arm in ("bwd", "jvp"):
        assert got[f"repro_torch.ssd_scan_{arm}"] == work.ssd_grad_work(b, l, h, p, g, n, c, 2,
                                                                          arm)[1]


def test_k3_k8_formulas_are_the_bound_counts():
    x, v = _meta(36551, 784, dtype=torch.float64), _meta(36551, dtype=torch.float64)
    flops, counts = _counted(lambda: rbf.rbf_matvec_op(x, v, 3.0, 3.0))
    nbytes, ops = work.rbf_work(36551, 784, 1, 8)
    assert flops == {"repro_torch.rbf_matvec": ops} and counts["bytes"] == nbytes
    xr, xc = _meta(4096, 784, dtype=torch.float64), _meta(16384, 784, dtype=torch.float64)
    vc = _meta(16384, dtype=torch.float64)
    flops, counts = _counted(lambda: rbf.rbf_matvec_rect_op(xr, xc, vc, 3.0, 3.0))
    nbytes, ops = work.rect_work(4096, 16384, 784, 1, 8)
    assert flops == {"repro_torch.rbf_matvec_rect": ops} and counts["bytes"] == nbytes


def _train_trace(cfg, shape):
    skeleton = transformer.Model(None, cfg, "meta")
    params = steps.params_dict(skeleton)
    batch = steps.input_specs(cfg, shape)
    return trace_stats.trace(lambda: steps.loss_and_grads(cfg, params, batch,
                                                          skeleton=skeleton),
                             live=[params, batch])[1]


def test_remat_lowers_the_traced_peak():
    cfg = registry.get_smoke_config("qwen1.5-0.5b")
    shape = registry.ShapeSpec("t", 1024, 8, "train")
    on = _train_trace(dataclasses.replace(cfg, remat=True), shape)
    off = _train_trace(dataclasses.replace(cfg, remat=False), shape)
    assert on["held_bytes"] == off["held_bytes"]
    assert on["peak_bytes"] - on["held_bytes"] < 0.6 * (off["peak_bytes"] - off["held_bytes"])
    assert on["flops"] > off["flops"]  # the recomputed forward
    assert on["op_census"]["repro_torch.flash_attention_lse"] == 2 * cfg.n_layers
    assert off["op_census"]["repro_torch.flash_attention_lse"] == cfg.n_layers


def test_trace_flops_are_flop_counter_modes():
    cfg = registry.get_smoke_config("mamba2-1.3b")
    shape = registry.ShapeSpec("t", 256, 2, "train")
    skeleton = transformer.Model(None, cfg, "meta")
    params = steps.params_dict(skeleton)
    batch = steps.input_specs(cfg, shape)
    with FlopCounterMode(display=False) as fc:
        _, counts = trace_stats.trace(lambda: steps.loss_and_grads(cfg, params, batch,
                                                                   skeleton=skeleton))
    assert counts["flops"] == fc.get_total_flops() > 0
    assert counts["op_census"]["repro_torch.ssd_scan_bwd"] == cfg.n_layers


def test_smoke_dryrun_every_cell(tmp_path):
    for arch, name in CELLS:
        rec = dryrun.run_cell(arch, name, str(tmp_path), smoke=True)
        jcfg = jregistry.get_smoke_config(arch)
        ok, why = jregistry.shape_applicable(jcfg, jregistry.SHAPES[name])
        if not ok:
            assert rec["status"] == "skipped" and rec["reason"] == why
            continue
        assert rec["status"] == "ok", rec.get("error")
        census = rec["op_census"]
        cfg = registry.get_smoke_config(arch)
        kinds = set(cfg.layer_kinds())
        if name == "train_4k":
            assert ("repro_torch.flash_attention_bwd" in census) == ("attn" in kinds)
            assert ("repro_torch.ssd_scan_bwd" in census) == ("ssm" in kinds)
        elif name == "prefill_32k":
            assert ("repro_torch.flash_attention" in census) == ("attn" in kinds)
            assert ("repro_torch.ssd_scan" in census) == ("ssm" in kinds)
        assert 0 < rec["peak_bytes"] and rec["max_batch"] >= 0
        assert rec["model_flops"] == jsteps.model_flops(jcfg, jregistry.SHAPES[name])
    for arch in ("gpc-mnist", "gpc-mnist-optx"):
        rec = dryrun.run_cell(arch, "", str(tmp_path))
        assert rec["status"] == "ok" and rec["fits"]
    assert "sharding layouts" in rec["note"]
    table = roofline.table(str(tmp_path))
    assert "gpc-mnist" in table and "skipped" in table
