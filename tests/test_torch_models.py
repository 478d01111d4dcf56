"""The model zoo's serving path in the PyTorch port against the JAX reference.

The same numpy inputs (and, for whole models, the reference's own
parameters from ``repro.models.init``, carried over by
``repro_torch.convert.model_params_from_numpy``) go through both packages
in one process, x64 on as ``tests/conftest.py`` sets it; the SMOKE models
compute in f32 since their ``dtype`` says so.

* K9 (flash attention): the port's plain version and oracle against
  ``ops.attention(impl="interpret")`` and ``ref.mha_attention`` over
  ``tests/test_kernels.py``'s ``ATTN_CASES``, f32 and bf16, at its ``_tol``.
* K10 (SSD scan): the plain version, the oracle and the stateful scan
  against ``ops.ssd(impl="interpret")``, ``ref.ssd_reference`` and
  ``_ssd_chunked(initial_state=, return_state=True)`` over ``SSD_CASES``
  (relative to the output's scale, as there); ``ssd_decode_step``.
* Layers, configs, the token pipeline and the FLOPs count.
* ``qwen1.5-smoke`` and ``mamba2-smoke`` end to end: ``forward_hidden``,
  ``prefill`` (last logits, cache and state contents) and four
  ``decode_step`` logits against the reference run with
  ``attn_impl="interpret"`` and ``"chunked"``, at 2e-4 / 5e-4; the same in
  bf16 at 2e-2 / 5e-2; the port's teacher-forced decode against its own
  forward; the parameter converter's round trip.

The CUDA kernels are held against these plain versions on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``; that ``repro_torch``
(models included) imports without JAX is checked by
``tests/test_torch_kernels.py::test_port_imports_without_jax_or_repro``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import models as jmodels  # noqa: E402
from repro.configs import registry as jregistry  # noqa: E402
from repro.data.tokens import TokenPipeline as JTokenPipeline  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import models as tmodels  # noqa: E402
from repro_torch.configs import registry as tregistry  # noqa: E402
from repro_torch.data import TokenPipeline  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ssd_scan as tss  # noqa: E402
from repro_torch.launch import make_prefill_step, make_serve_step, model_flops  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402

F32, BF16 = "float32", "bfloat16"
JDT = {F32: jnp.float32, BF16: jnp.bfloat16}
TDT = {F32: torch.float32, BF16: torch.bfloat16}
ARCHS = ("qwen1.5-0.5b", "mamba2-1.3b")
B, S, MAX_LEN, DECODE = 2, 24, 32, 4

# tests/test_kernels.py's cases: b, h, hkv, sq, sk, dh, causal, q_offset ...
ATTN_CASES = [
    (2, 4, 2, 64, 64, 32, False, 0),
    (1, 8, 2, 96, 96, 64, True, 0),
    (2, 4, 4, 1, 133, 64, True, 132),   # decode
    (1, 2, 1, 40, 200, 16, False, 0),   # cross-attention shape
    (1, 16, 2, 33, 33, 128, True, 0),   # ragged blocks
]
# ... and b, l, h, p, g, n, chunk.
SSD_CASES = [
    (1, 64, 2, 16, 1, 16, 32),
    (2, 100, 4, 8, 2, 24, 32),
    (1, 37, 2, 4, 2, 8, 16),     # ragged chunk
    (2, 128, 8, 32, 1, 64, 64),
]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch on one CPU thread for the module: its products are small (SMOKE
    widths), and beside the suite's other workers (six, of eight threads each,
    on eight cores) a pool of all cores waits on every parallel region."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tol(dtype, scale=1.0):
    """``tests/test_kernels.py``'s tolerances."""
    return dict(rtol=scale * (2e-2 if dtype == BF16 else 2e-4),
                atol=scale * (5e-2 if dtype == BF16 else 5e-4))


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _close(got, want, **tol):
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def _port_cfg(cfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(cfg))


def _load(module, ref_params):
    """Load a reference layer's parameter dict into a port module."""
    module.load_state_dict({convert._port_leaf(k): torch.as_tensor(np.asarray(v))
                            for k, v in ref_params.items()})
    return module


# ---------------------------------------------------------------------------
# K9: attention
# ---------------------------------------------------------------------------


def _attn_inputs(case, dtype):
    b, h, hkv, sq, sk, dh, _, _ = case
    rng = np.random.default_rng(sum(case[:6]))
    arrs = [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, h, sq, dh), (b, hkv, sk, dh), (b, hkv, sk, dh))]
    return ([jnp.asarray(a, JDT[dtype]) for a in arrs],
            [torch.as_tensor(a).to(TDT[dtype]) for a in arrs])


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("case", ATTN_CASES)
def test_attention_plain_matches_pallas_interpret(case, dtype):
    causal, off = case[6], case[7]
    (jq, jk, jv), (q, k, v) = _attn_inputs(case, dtype)
    want = jops.attention(jq, jk, jv, causal=causal, q_offset=off, impl="interpret",
                          block_q=32, block_k=32)
    got = tops.attention(q, k, v, causal=causal, q_offset=off, backend="plain",
                         block_q=32, block_k=32)
    assert got.dtype == TDT[dtype] and got.shape == q.shape
    _close(got, want, **_tol(dtype))


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("case", ATTN_CASES)
def test_attention_oracle_matches_reference_oracle(case, dtype):
    causal, off = case[6], case[7]
    (jq, jk, jv), (q, k, v) = _attn_inputs(case, dtype)
    want = jref.mha_attention(jq, jk, jv, causal=causal, q_offset=off)
    got = tops.attention(q, k, v, causal=causal, q_offset=off, backend="reference")
    _close(got, want, **_tol(dtype))


def test_attention_blocks_change_nothing_but_rounding():
    """The plain version's blocks are a memory bound, not a result: the
    reference's default blocks and tiny ones agree."""
    (_, _, _), (q, k, v) = _attn_inputs((1, 8, 2, 96, 96, 64, True, 0), F32)
    big = tops.attention(q, k, v, causal=True, backend="plain")
    small = tops.attention(q, k, v, causal=True, backend="plain", block_q=16, block_k=8)
    _close(big, small, rtol=1e-5, atol=1e-5)


def _plain_with_f32_p(q, k, v, causal, q_offset, block):
    """The plain version's loop with ``p`` kept in f32 for ``p @ v`` (the
    Pallas body's arithmetic, and the plain version before the
    tensor-core kernel rounded ``p``)."""
    b, h, sq, dh = q.shape
    group, sk = h // k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    for q0 in range(0, sq, block):
        qi = q[:, :, q0 : q0 + block].float()
        qpos = q_offset + q0 + torch.arange(qi.shape[2])[:, None]
        m = torch.full((b, h, qi.shape[2], 1), tfa.NEG_INF)
        l = torch.zeros((b, h, qi.shape[2], 1))
        acc = torch.zeros((b, h, qi.shape[2], dh))
        for k0 in range(0, sk, block):
            kj = k[:, :, k0 : k0 + block].float().repeat_interleave(group, dim=1)
            vj = v[:, :, k0 : k0 + block].float().repeat_interleave(group, dim=1)
            s = torch.einsum("bhqd,bhkd->bhqk", qi, kj) * dh**-0.5
            kpos = k0 + torch.arange(kj.shape[2])[None, :]
            mask = (kpos < sk) & (kpos <= qpos) if causal else kpos < sk
            s = torch.where(mask, s, tfa.NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp(s - m_new)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1, keepdim=True)
            acc = acc * corr + torch.einsum("bhqk,bhkd->bhqd", p, vj)
            m = m_new
        out[:, :, q0 : q0 + block] = (acc / torch.where(l == 0.0, 1.0, l)).to(q.dtype)
    return out


@pytest.mark.parametrize("case", ATTN_CASES)
def test_attention_plain_rounds_p_only_in_bf16(case):
    """The plain version rounds ``p`` to bf16 before ``p @ v`` for bf16
    inputs, as the tensor-core kernel does, and stays within the bf16 bar
    of the Pallas interpret arm (which keeps ``p`` in f32); in f32 it is
    bit for bit the loop without that rounding."""
    causal, off = case[6], case[7]
    (_, _, _), (q, k, v) = _attn_inputs(case, F32)
    got = tfa.flash_attention_plain(q, k, v, causal=causal, q_offset=off, block_q=32,
                                    block_k=32)
    assert torch.equal(got, _plain_with_f32_p(q, k, v, causal, off, 32))
    (jq, jk, jv), (q, k, v) = _attn_inputs(case, BF16)
    got = tfa.flash_attention_plain(q, k, v, causal=causal, q_offset=off, block_q=32,
                                    block_k=32)
    want = jops.attention(jq, jk, jv, causal=causal, q_offset=off, impl="interpret",
                          block_q=32, block_k=32)
    _close(got, want, **_tol(BF16))


def test_kernel_wrappers_refuse_cpu_tensors():
    q = torch.zeros(1, 2, 4, 16)
    with pytest.raises(ValueError, match="CUDA"):
        tops.attention(q, q, q, backend="cuda")
    with pytest.raises(ValueError, match="CUDA kernel"):
        tfa.flash_attention_cuda(q, q, q)
    x = torch.zeros(1, 8, 2, 4)
    bmat = torch.zeros(1, 8, 1, 4)
    dt, a = torch.zeros(1, 8, 2), torch.zeros(2)
    with pytest.raises(ValueError, match="CUDA"):
        tops.ssd(x, dt, a, bmat, bmat, backend="cuda")
    with pytest.raises(ValueError, match="CUDA kernel"):
        tss.ssd_scan_cuda(x, dt, a, bmat, bmat)


# ---------------------------------------------------------------------------
# K10: SSD scan
# ---------------------------------------------------------------------------


def _ssd_inputs(case, dtype=F32):
    b, l, h, p, g, n, _ = case
    rng = np.random.default_rng(sum(case))
    x = rng.standard_normal((b, l, h, p)).astype(np.float32)
    dt = rng.uniform(0.01, 0.4, (b, l, h)).astype(np.float32)
    a = (-rng.uniform(0.3, 2.0, (h,))).astype(np.float32)
    bm = rng.standard_normal((b, l, g, n)).astype(np.float32)
    cm = rng.standard_normal((b, l, g, n)).astype(np.float32)
    d = rng.standard_normal((h,)).astype(np.float32)
    h0 = rng.standard_normal((b, h, p, n)).astype(np.float32)
    low = (x, bm, cm)  # in the working dtype; dt, a, d and the state stay f32
    jx, jb, jc = (jnp.asarray(t, JDT[dtype]) for t in low)
    tx, tb, tc = (torch.as_tensor(t).to(TDT[dtype]) for t in low)
    jrest = [jnp.asarray(t) for t in (dt, a, d, h0)]
    trest = [torch.as_tensor(t) for t in (dt, a, d, h0)]
    return (jx, jrest[0], jrest[1], jb, jc, jrest[2], jrest[3]), (
        tx, trest[0], trest[1], tb, tc, trest[2], trest[3])


def _scaled(got, want, dtype=F32):
    want = _np(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(_np(got) / scale, want / scale, **_tol(dtype, 2.0))


@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_plain_matches_pallas_interpret(case):
    (jx, jdt, ja, jb, jc, jd, _), (x, dt, a, bm, cm, d, _) = _ssd_inputs(case)
    want = jops.ssd(jx, jdt, ja, jb, jc, jd, impl="interpret", chunk=case[-1])
    got = tops.ssd(x, dt, a, bm, cm, d, backend="plain", chunk=case[-1])
    _scaled(got, want)


@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_oracle_matches_sequential_reference(case):
    (jx, jdt, ja, jb, jc, jd, _), (x, dt, a, bm, cm, d, _) = _ssd_inputs(case)
    want = jref.ssd_reference(jx, jdt, ja, jb, jc, jd)
    got = tops.ssd(x, dt, a, bm, cm, d, backend="reference")
    _scaled(got, want)


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_with_state_matches_chunked(case, dtype):
    """The prefill form: seeded with a state and returning the final one,
    against the reference's ``_ssd_chunked`` (x, B, C in ``dtype``)."""
    (jx, jdt, ja, jb, jc, jd, jh0), (x, dt, a, bm, cm, d, h0) = _ssd_inputs(case, dtype)
    wy, wh = jops._ssd_chunked(jx, jdt, ja, jb, jc, jd, case[-1], initial_state=jh0,
                               return_state=True)
    gy, gh = tops.ssd(x, dt, a, bm, cm, d, backend="plain", chunk=case[-1],
                      initial_state=h0, return_state=True)
    assert gy.dtype == torch.float32 and gh.dtype == torch.float32  # y + x·d (f32 d)
    _scaled(gy, wy, dtype)
    _scaled(gh, wh, dtype)


def test_ssd_decode_step_matches_reference_and_scan():
    case = (2, 20, 4, 8, 2, 8, 8)
    (jx, jdt, ja, jb, jc, jd, _), (x, dt, a, bm, cm, d, _) = _ssd_inputs(case)
    jstate = jnp.zeros((2, 4, 8, 8), jnp.float32)
    state = torch.zeros(2, 4, 8, 8)
    outs = []
    for t in range(case[1]):
        jstate, jy = jops.ssd_decode_step(jstate, jx[:, t], jdt[:, t], ja, jb[:, t], jc[:, t], jd)
        state, y = tops.ssd_decode_step(state, x[:, t], dt[:, t], a, bm[:, t], cm[:, t], d)
        _close(y, jy, rtol=1e-5, atol=1e-5)
        outs.append(y)
    _close(state, jstate, rtol=1e-5, atol=1e-5)
    full = tops.ssd(x, dt, a, bm, cm, d, backend="plain", chunk=8)
    _close(torch.stack(outs, dim=1), full, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# Layers, configs, data, steps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pct", [1.0, 0.25])
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_rope(pct, dtype):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 12, 4, 32)).astype(np.float32)
    pos = (5 + np.arange(12))[None, :]
    want = jlayers.rope_apply(jnp.asarray(x, JDT[dtype]), jnp.asarray(pos), 10000.0, pct)
    got = tlayers.rope_apply(torch.as_tensor(x).to(TDT[dtype]), torch.as_tensor(pos),
                             10000.0, pct)
    assert got.dtype == TDT[dtype]
    _close(got, want, **(_tol(dtype) if dtype == BF16 else dict(rtol=1e-5, atol=1e-5)))


@pytest.mark.parametrize("norm_type", ["rms", "layer"])
def test_norms(norm_type):
    jcfg = dataclasses.replace(jregistry.get_smoke_config("qwen1.5-0.5b"), norm_type=norm_type)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    jp = {k: v + rng.standard_normal(v.shape).astype(np.float32)
          for k, v in jax.tree_util.tree_map(np.asarray, jlayers.norm_init(jcfg)).items()}
    want = jlayers.norm_apply(jp, jnp.asarray(x), jcfg)
    norm = _load(tlayers.norm_init(_port_cfg(jcfg), device="cpu"), jp)
    _close(tlayers.norm_apply(norm, torch.as_tensor(x), _port_cfg(jcfg)), want,
           rtol=1e-5, atol=1e-5)
    scale = rng.standard_normal(16).astype(np.float32)
    heads = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    _close(tlayers.rms_head_norm(torch.as_tensor(scale), torch.as_tensor(heads), 1e-5),
           jlayers.rms_head_norm(jnp.asarray(scale), jnp.asarray(heads), 1e-5),
           rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mlp_type", ["swiglu", "gelu"])
def test_mlps(mlp_type):
    jcfg = dataclasses.replace(jregistry.get_smoke_config("qwen1.5-0.5b"), mlp_type=mlp_type)
    jp = jlayers.mlp_init(jax.random.PRNGKey(2), jcfg)
    if mlp_type == "gelu":  # non-zero biases, so the test sees them
        jp = {k: v + 0.1 if "bias" in k else v for k, v in jp.items()}
    x = np.random.default_rng(5).standard_normal((2, 5, 64)).astype(np.float32)
    mlp = _load(tlayers.mlp_init(None, _port_cfg(jcfg), device="cpu"), jp)
    _close(tlayers.mlp_apply(mlp, torch.as_tensor(x), _port_cfg(jcfg)),
           jlayers.mlp_apply(jp, jnp.asarray(x), jcfg), rtol=2e-5, atol=2e-5)


def test_sinusoidal_positions_rows():
    want = np.asarray(jlayers.sinusoidal_positions(300, 64, jnp.float32))
    _close(tlayers.sinusoidal_positions(300, 64, torch.float32, device="cpu"), want,
           rtol=1e-5, atol=1e-5)
    _close(tlayers.sinusoidal_positions(7, 64, torch.float32, start=250, device="cpu"),
           want[250:257], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch):
    for get in ("get_config", "get_smoke_config"):
        jcfg, tcfg = getattr(jregistry, get)(arch), getattr(tregistry, get)(arch)
        assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
        for prop in ("head_dim", "d_inner", "n_ssm_heads", "is_encdec"):
            assert getattr(jcfg, prop) == getattr(tcfg, prop)
        for fn in ("layer_kinds", "ffn_kinds", "period", "active_params", "total_params"):
            assert getattr(jcfg, fn)() == getattr(tcfg, fn)()
        assert tlayers.padded_vocab(tcfg) == jlayers.padded_vocab(jcfg)
        for name, shape in tregistry.SHAPES.items():
            jshape = jregistry.SHAPES[name]
            assert dataclasses.asdict(shape) == dataclasses.asdict(jshape)
            assert model_flops(tcfg, shape) == jsteps.model_flops(jcfg, jshape)


def test_token_pipeline_matches_reference():
    for step in (0, 3):
        want = JTokenPipeline(151936, 3, 50, seed=2).make_batch(step)
        got = TokenPipeline(151936, 3, 50, seed=2).make_batch(step)
        for key in ("tokens", "labels"):
            np.testing.assert_array_equal(got[key], want[key])


# ---------------------------------------------------------------------------
# Whole models
# ---------------------------------------------------------------------------


def _tokens(cfg):
    return np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def _reference_run(cfg, params, tokens):
    """forward_hidden, prefill (state, last logits) and DECODE steps of the
    reference, teacher-forced on the prompt's first tokens."""
    jtok = jnp.asarray(tokens)
    hidden, _ = jmodels.forward_hidden(params, {"tokens": jtok}, cfg)
    state = jmodels.init_decode_state(cfg, B, MAX_LEN)
    state, last = jmodels.prefill(params, {"tokens": jtok}, state, cfg)
    steps = []
    for t in range(DECODE):
        logits, state = jmodels.decode_step(params, jtok[:, t : t + 1], state, cfg)
        steps.append(logits)
    return {"hidden": hidden, "last": last, "prefill_state": None, "steps": steps}


def _port_run(model, cfg, tokens):
    hidden, _ = tmodels.forward_hidden(model, {"tokens": tokens}, cfg)
    state = tmodels.init_decode_state(cfg, B, MAX_LEN, device="cpu")
    prefill = make_prefill_step(cfg, MAX_LEN)
    serve = make_serve_step(cfg)
    state, last = prefill(model, {"tokens": tokens}, state)
    caches = [tuple(t.clone() if isinstance(t, torch.Tensor) else t for t in c)
              for c in state.caches]
    steps = []
    for t in range(DECODE):
        logits, state = serve(model, tokens[:, t : t + 1], state)
        steps.append(logits)
    return {"hidden": hidden, "last": last, "caches": caches, "steps": steps,
            "length": state.length}


@pytest.fixture(scope="module")
def runs():
    """Both packages on both SMOKE models, the reference under both of its
    lowerings (one JAX init and one port model per arch)."""
    out = {}
    for arch in ARCHS:
        base = jregistry.get_smoke_config(arch)
        params = jmodels.init(jax.random.PRNGKey(0), base)
        tree = jax.tree_util.tree_map(np.asarray, params)
        tcfg = tregistry.get_smoke_config(arch)
        model = convert.model_params_from_numpy(tree, tcfg, device="cpu")
        tokens = _tokens(tcfg)
        out[arch] = {"tree": tree, "model": model, "cfg": tcfg,
                     "port": _port_run(model, tcfg, tokens)}
        for impl in ("interpret", "chunked"):
            jcfg = dataclasses.replace(base, attn_impl=impl)
            ref = _reference_run(jcfg, params, tokens)
            jtok = jnp.asarray(tokens)
            state = jmodels.init_decode_state(jcfg, B, MAX_LEN)
            ref["prefill_state"], _ = jmodels.prefill(params, {"tokens": jtok}, state, jcfg)
            out[arch][impl] = ref
    return out


TIGHT = dict(rtol=2e-4, atol=5e-4)


@pytest.mark.parametrize("impl", ["interpret", "chunked"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_hidden_matches_reference(runs, arch, impl):
    got, want = runs[arch]["port"]["hidden"], runs[arch][impl]["hidden"]
    assert got.shape == (B, S, runs[arch]["cfg"].d_model)
    _close(got, want, **TIGHT)


@pytest.mark.parametrize("impl", ["interpret", "chunked"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_reference(runs, arch, impl):
    run, ref = runs[arch]["port"], runs[arch][impl]
    cfg = runs[arch]["cfg"]
    assert run["last"].shape == (B, 1, tlayers.padded_vocab(cfg))
    _close(run["last"], ref["last"], **TIGHT)
    jstate = ref["prefill_state"]
    assert int(jstate.length) == S
    for layer, cache in enumerate(run["caches"]):
        jcache = jax.tree_util.tree_map(lambda leaf: leaf[layer], jstate.caches[0])
        if cfg.layer_kinds()[layer] == "attn":
            assert cache[2] == int(jcache.length) == S
            _close(cache[0], jcache.k, **TIGHT)
            _close(cache[1], jcache.v, **TIGHT)
        else:
            _close(cache[0], jcache.conv, **TIGHT)
            _close(cache[1], jcache.ssd, **TIGHT)


@pytest.mark.parametrize("impl", ["interpret", "chunked"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_reference(runs, arch, impl):
    run, ref = runs[arch]["port"], runs[arch][impl]
    assert run["length"] == S + DECODE
    for got, want in zip(run["steps"], ref["steps"]):
        _close(got, want, **TIGHT)


def test_kv_cache_overflow_raises(runs):
    """A prefill or decode step past the cache's ``max_len`` raises instead
    of silently dropping keys (the reference clamps the write); the step
    that fills the cache's last slot still matches the reference."""
    arch = "qwen1.5-0.5b"
    model, cfg = runs[arch]["model"], runs[arch]["cfg"]
    tokens = _tokens(cfg)
    jcfg = dataclasses.replace(jregistry.get_smoke_config(arch), attn_impl="chunked")
    params = jax.tree_util.tree_map(jnp.asarray, runs[arch]["tree"])
    jtok = jnp.asarray(tokens)
    jstate = jmodels.init_decode_state(jcfg, B, S + 1)
    jstate, _ = jmodels.prefill(params, {"tokens": jtok}, jstate, jcfg)
    want, _ = jmodels.decode_step(params, jtok[:, :1], jstate, jcfg)

    state = tmodels.init_decode_state(cfg, B, S + 1, device="cpu")
    state, _ = tmodels.prefill(model, {"tokens": tokens}, state, cfg)
    got, state = tmodels.decode_step(model, tokens[:, :1], state, cfg)
    assert state.length == S + 1
    _close(got, want, **TIGHT)
    with pytest.raises(ValueError, match=rf"{S + 1} cached \+ 1 new tokens > max_len {S + 1}"):
        tmodels.decode_step(model, tokens[:, 1:2], state, cfg)
    short = tmodels.init_decode_state(cfg, B, S - 1, device="cpu")
    with pytest.raises(ValueError, match=rf"0 cached \+ {S} new tokens > max_len {S - 1}"):
        tmodels.prefill(model, {"tokens": tokens}, short, cfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_teacher_forced_decode_matches_own_forward(runs, arch):
    """The port's KV-cache / SSM-state invariant (the reference's
    ``test_archs_smoke.py::test_decode_matches_forward``), in f32."""
    model, cfg = runs[arch]["model"], runs[arch]["cfg"]
    tokens = _tokens(cfg)
    hidden, _ = tmodels.forward_hidden(model, {"tokens": tokens}, cfg)
    full = hidden @ tlayers.lm_head_weights(model.embed, cfg)
    state = tmodels.init_decode_state(cfg, B, S, device="cpu")
    steps = []
    for t in range(S):
        logits, state = tmodels.decode_step(model, tokens[:, t : t + 1], state, cfg)
        steps.append(logits[:, 0])
    _close(torch.stack(steps, dim=1), full, **TIGHT)


@pytest.mark.parametrize("arch", ARCHS)
def test_converter_round_trip(runs, arch):
    tree = runs[arch]["tree"]
    back = convert.model_params_to_numpy(runs[arch]["model"])
    flat, treedef = jax.tree_util.tree_flatten(tree)
    flat_back, treedef_back = jax.tree_util.tree_flatten(back)
    assert treedef == treedef_back
    for a, b in zip(flat, flat_back):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(KeyError):
        bad = {**tree, "embed": {**tree["embed"], "table_rs": tree["embed"]["table_vs"]}}
        convert.model_params_from_numpy(bad, runs[arch]["cfg"], device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_serving_matches_reference(runs, arch):
    """The SMOKE models at ``dtype="bfloat16"`` (f32 parameters, as at full
    width): forward, prefill and one decode step at bf16 tolerance."""
    jcfg = dataclasses.replace(jregistry.get_smoke_config(arch), dtype=BF16)
    tcfg = _port_cfg(jcfg)
    params = jax.tree_util.tree_map(jnp.asarray, runs[arch]["tree"])
    tokens = _tokens(tcfg)
    model = convert.model_params_from_numpy(runs[arch]["tree"], tcfg, device="cpu")
    ref = _reference_run(jcfg, params, tokens)
    run = _port_run(model, tcfg, tokens)
    assert run["hidden"].dtype == torch.bfloat16
    _close(run["hidden"], ref["hidden"], **_tol(BF16))
    _close(run["last"], ref["last"], **_tol(BF16))
    for got, want in zip(run["steps"], ref["steps"]):
        _close(got, want, **_tol(BF16))


def test_unported_families_raise():
    """No family is refused any more: a MoE configuration builds (the zoo's
    MoE models: ``tests/test_torch_zoo.py``), and an encoder–decoder one
    builds an encoder and cross blocks and serves a step
    (``tests/test_torch_encdec.py`` holds it to the reference)."""
    moe = ModelConfig(name="moe", family="moe", n_layers=2, d_model=64, n_heads=4,
                      n_kv_heads=4, d_ff=128, vocab_size=256, n_experts=4,
                      experts_per_token=2, dtype=F32)
    model = tmodels.init(torch.Generator().manual_seed(0), moe, device="cpu")
    assert all(hasattr(block, "moe") for block in model.blocks)
    assert not hasattr(model, "encoder")
    encdec = dataclasses.replace(moe, family="audio", n_experts=0, encoder_layers=3,
                                 cross_attention=True, rope=False, input_mode="embeddings")
    model = tmodels.init(torch.Generator().manual_seed(0), encdec, device="cpu")
    assert len(model.encoder.blocks) == 3
    assert all(hasattr(b, "mlp") and not hasattr(b, "cross_attn") for b in model.encoder.blocks)
    assert all(hasattr(b, "cross_norm") and hasattr(b, "cross_attn") for b in model.blocks)
    batch = {"src_embeds": torch.randn(1, 10, 64, generator=torch.Generator().manual_seed(1)),
             "tokens": torch.tensor([[3, 4, 5]])}
    state = tmodels.init_decode_state(encdec, 1, 8, device="cpu")
    state, last = tmodels.prefill(model, batch, state, encdec)
    assert len(state.memory) == 2 and state.memory[0][0].shape == (1, 4, 10, 16)
    logits, state = tmodels.decode_step(model, last[:, -1, :256].argmax(-1, keepdim=True), state,
                                        encdec)
    assert state.length == 4 and bool(torch.isfinite(logits).all())
