"""The decoder-only zoo of the PyTorch port against the JAX reference.

The seven architectures after qwen1.5 and mamba2 (``test_torch_models.py``)
at SMOKE, each built once from the reference's own parameters
(``repro.models.init``, carried over by ``convert.model_params_from_numpy``;
a module fixture): the dense qwen3 (qk-norm), starcoder2 (LayerNorm, GELU,
QKV bias), stablelm (LayerNorm, 25 % rotary) and chameleon (qk-norm); the
MoE olmoe (top-2 of 8, dropless at SMOKE) and arctic (MoE plus a dense
residual MLP); the hybrid jamba (SSD layers, one attention layer and MoE
every other layer in its period of 8).

* configurations, layer kinds, periods and parameter counts equal (the
  encoder–decoder seamless too; its runs are ``test_torch_encdec.py``'s);
* ``forward_hidden`` (its aux loss too), ``prefill`` (last logits, cache
  and state contents) and four ``decode_step`` logits against the
  reference run with ``attn_impl="interpret"`` and ``"chunked"`` at 2e-4 /
  5e-4, as ``test_torch_models.py`` holds qwen1.5 and mamba2;
* ``lm_loss`` and its gradients for olmoe, arctic and jamba (1e-5 loss,
  2e-4 of each leaf's max abs), as ``test_torch_train.py``;
* ``tests/test_archs_smoke.py::test_grad_step`` mirrored for the seven;
* ``cfg.remat`` (each block under ``torch.utils.checkpoint``) changes no
  gradient bit for qwen1.5, mamba2 and olmoe, and is taken only where the
  reference takes it (no caches, not inside ``torch.func``);
* the converter's round trip for the MoE and hybrid trees, and a port
  checkpoint of a MoE model restored by the reference in its layout.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import models as jmodels  # noqa: E402
from repro.checkpoint import restore_pytree as j_restore  # noqa: E402
from repro.configs import registry as jregistry  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import models as tmodels  # noqa: E402
from repro_torch.checkpoint import save_pytree  # noqa: E402
from repro_torch.configs import registry as tregistry  # noqa: E402
from repro_torch.data import TokenPipeline  # noqa: E402
from repro_torch.launch import (  # noqa: E402
    loss_and_grads,
    make_prefill_step,
    make_serve_step,
    model_flops,
    params_dict,
)
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer  # noqa: E402

ARCHS = ("qwen3-8b", "starcoder2-3b", "stablelm-12b", "chameleon-34b", "olmoe-1b-7b",
         "arctic-480b", "jamba-v0.1-52b", "seamless-m4t-large-v2")
DECODER_ONLY = ARCHS[:-1]  # run on tokens alone below
MOE = ("olmoe-1b-7b", "arctic-480b", "jamba-v0.1-52b")
B, S, MAX_LEN, DECODE = 2, 24, 32, 4
TIGHT = dict(rtol=2e-4, atol=5e-4)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch on one CPU thread for the module: its products are small (SMOKE
    widths), and beside the suite's other workers (six, of eight threads each,
    on eight cores) a pool of all cores waits on every parallel region."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _close(got, want, **tol):
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def test_registry_holds_every_decoder_only_arch():
    """The registry holds every arch of the reference, the encoder–decoder
    included, and seamless builds (an encoder, cross blocks, the
    reference's parameter count)."""
    assert tregistry.ARCH_IDS == jregistry.ARCH_IDS
    arch = "seamless-m4t-large-v2"
    cfg = tregistry.get_smoke_config(arch)
    model = tmodels.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert len(model.encoder.blocks) == cfg.encoder_layers
    assert all(hasattr(block, "cross_attn") for block in model.blocks)
    jparams = jmodels.init(jax.random.PRNGKey(0), jregistry.get_smoke_config(arch))
    assert sum(p.numel() for p in model.parameters()) == sum(
        leaf.size for leaf in jax.tree_util.tree_leaves(jparams))


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
            assert model_flops(tcfg, shape) == jsteps.model_flops(jcfg, jregistry.SHAPES[name])


def _tokens(cfg):
    return np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def _reference_run(cfg, params, tokens):
    """The reference's forward, prefill and decode steps, jitted (eager
    JAX dispatches the SMOKE models' small ops one by one)."""
    jtok = jnp.asarray(tokens)
    hidden, aux = jax.jit(jmodels.forward_hidden, static_argnums=2)(params, {"tokens": jtok},
                                                                   cfg)
    state = jmodels.init_decode_state(cfg, B, MAX_LEN)
    state, last = jax.jit(jmodels.prefill, static_argnums=3)(params, {"tokens": jtok}, state,
                                                            cfg)
    prefill_state = state
    decode = jax.jit(jmodels.decode_step, static_argnums=3)
    steps = []
    for t in range(DECODE):
        logits, state = decode(params, jtok[:, t : t + 1], state, cfg)
        steps.append(logits)
    return {"hidden": hidden, "aux": aux, "last": last, "prefill_state": prefill_state,
            "steps": steps}


def _port_run(model, cfg, tokens):
    hidden, aux = tmodels.forward_hidden(model, {"tokens": tokens}, cfg)
    state = tmodels.init_decode_state(cfg, B, MAX_LEN, device="cpu")
    state, last = make_prefill_step(cfg, MAX_LEN)(model, {"tokens": tokens}, state)
    caches = [tuple(t.clone() if isinstance(t, torch.Tensor) else t for t in c)
              for c in state.caches]
    serve = make_serve_step(cfg)
    steps = []
    for t in range(DECODE):
        logits, state = serve(model, tokens[:, t : t + 1], state)
        steps.append(logits)
    return {"hidden": hidden, "aux": aux, "last": last, "caches": caches, "steps": steps,
            "length": state.length}


@pytest.fixture(scope="module")
def runs():
    """Both packages on every SMOKE model, the reference under both of its
    lowerings (one reference init and one port model per arch)."""
    out = {}
    for arch in DECODER_ONLY:
        base = jregistry.get_smoke_config(arch)
        params = jmodels.init(jax.random.PRNGKey(0), base)
        tree = jax.tree_util.tree_map(np.asarray, params)
        tcfg = tregistry.get_smoke_config(arch)
        model = convert.model_params_from_numpy(tree, tcfg, device="cpu")
        tokens = _tokens(tcfg)
        out[arch] = {"params": params, "tree": tree, "model": model, "cfg": tcfg,
                     "port": _port_run(model, tcfg, tokens)}
        for impl in ("interpret", "chunked"):
            out[arch][impl] = _reference_run(dataclasses.replace(base, attn_impl=impl), params,
                                             tokens)
    return out


@pytest.mark.parametrize("impl", ["interpret", "chunked"])
@pytest.mark.parametrize("arch", DECODER_ONLY)
def test_forward_hidden_matches_reference(runs, arch, impl):
    got, want = runs[arch]["port"], runs[arch][impl]
    assert got["hidden"].shape == (B, S, runs[arch]["cfg"].d_model)
    _close(got["hidden"], want["hidden"], **TIGHT)
    assert got["aux"].dtype == torch.float32
    if arch in MOE:
        assert float(want["aux"]) > 0
    _close(got["aux"], want["aux"], rtol=1e-5, atol=0)


@pytest.mark.parametrize("impl", ["interpret", "chunked"])
@pytest.mark.parametrize("arch", DECODER_ONLY)
def test_prefill_matches_reference(runs, arch, impl):
    run, ref = runs[arch]["port"], runs[arch][impl]
    cfg = runs[arch]["cfg"]
    period = cfg.period()
    assert run["last"].shape == (B, 1, tlayers.padded_vocab(cfg))
    _close(run["last"], ref["last"], **TIGHT)
    jstate = ref["prefill_state"]
    assert int(jstate.length) == S
    for layer, cache in enumerate(run["caches"]):
        # layer j·period + i is period j, block i there
        jcache = jax.tree_util.tree_map(lambda leaf: leaf[layer // period],
                                        jstate.caches[layer % period])
        if cfg.layer_kinds()[layer] == "attn":
            assert cache[2] == int(jcache.length) == S
            _close(cache[0], jcache.k, **TIGHT)
            _close(cache[1], jcache.v, **TIGHT)
        else:
            _close(cache[0], jcache.conv, **TIGHT)
            _close(cache[1], jcache.ssd, **TIGHT)


@pytest.mark.parametrize("impl", ["interpret", "chunked"])
@pytest.mark.parametrize("arch", DECODER_ONLY)
def test_decode_steps_match_reference(runs, arch, impl):
    run, ref = runs[arch]["port"], runs[arch][impl]
    assert run["length"] == S + DECODE
    for got, want in zip(run["steps"], ref["steps"]):
        _close(got, want, **TIGHT)


def _batch(cfg):
    batch = TokenPipeline(cfg.vocab_size, B, S, seed=3).make_batch(0)
    batch["labels"] = batch["labels"].copy()
    batch["labels"][0, :5] = -1
    return batch


@pytest.mark.parametrize("arch", MOE)
def test_lm_loss_and_gradients_match_reference(runs, arch):
    """The loss (with the routers' aux term) and every gradient leaf against
    ``jax.value_and_grad`` of the reference's ``lm_loss``, three loss
    chunks."""
    jcfg = dataclasses.replace(jregistry.get_smoke_config(arch), logits_chunk=8)
    tcfg = dataclasses.replace(runs[arch]["cfg"], logits_chunk=8)
    batch = _batch(tcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jmodels.lm_loss(p, b, jcfg), has_aux=True))(runs[arch]["params"], jb)
    params = convert.train_params_from_numpy(runs[arch]["tree"], tcfg, device="cpu")
    loss, metrics, grads = loss_and_grads(tcfg, params, batch)
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    assert float(metrics["aux"]) > 0
    assert abs(float(metrics["aux"]) - float(jmet["aux"])) <= 1e-5 * float(jmet["aux"])
    want = convert.model_state_from_numpy(jax.tree_util.tree_map(np.asarray, jgrads), tcfg)
    assert set(want) == set(grads) and any(".moe." in name for name in grads)
    for name, g in grads.items():
        scale = np.abs(want[name]).max()
        assert scale > 0, name
        assert np.abs(g.numpy() - want[name]).max() <= 2e-4 * scale, name


@pytest.mark.parametrize("arch", DECODER_ONLY)
def test_grad_step(runs, arch):
    cfg = runs[arch]["cfg"]
    params = params_dict(tmodels.init(torch.Generator().manual_seed(0), cfg, device="cpu"))
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)),
             "labels": rng.integers(0, cfg.vocab_size, (B, S))}
    loss, _, grads = loss_and_grads(cfg, params, batch)
    assert np.isfinite(float(loss))
    assert all(bool(torch.isfinite(g).all()) for g in grads.values())
    assert any(float(g.abs().max()) > 0 for g in grads.values())


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "mamba2-1.3b", "olmoe-1b-7b"])
def test_remat_changes_no_gradient_bit(arch, monkeypatch):
    cfg = dataclasses.replace(tregistry.get_smoke_config(arch), logits_chunk=8)
    assert cfg.remat
    params = params_dict(tmodels.init(torch.Generator().manual_seed(0), cfg, device="cpu"))
    batch = _batch(cfg)
    calls = []
    real = transformer.checkpoint
    monkeypatch.setattr(transformer, "checkpoint",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    loss_on, _, on = loss_and_grads(cfg, params, batch)
    assert len(calls) == cfg.n_layers  # one checkpoint a block
    loss_off, _, off = loss_and_grads(dataclasses.replace(cfg, remat=False), params, batch)
    assert len(calls) == cfg.n_layers
    assert torch.equal(loss_on, loss_off)
    assert all(torch.equal(on[name], off[name]) for name in on)
    # Serving and torch.func passes never checkpoint.
    model = tmodels.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    tokens = torch.as_tensor(batch["tokens"])
    state = tmodels.init_decode_state(cfg, B, S + 1, device="cpu")
    tmodels.prefill(model, {"tokens": tokens}, state, cfg)

    def hidden_sum(p):
        return torch.func.functional_call(model, p, (tmodels.forward_hidden, {"tokens": tokens},
                                                     cfg))[0].float().sum()

    torch.func.grad(hidden_sum)({k: v.detach() for k, v in params.items()})
    assert len(calls) == cfg.n_layers


def test_remat_recompute_keeps_the_forward_routing():
    """The forward replays another batch's routing and the backward runs
    after ``replay_routing`` has closed: the checkpointed blocks recompute
    on the expert ids their forward took, not on their own top-k, so the
    gradients equal those without remat bit for bit; ``record_routing``
    sees each layer once."""
    cfg = dataclasses.replace(tregistry.get_smoke_config("olmoe-1b-7b"), logits_chunk=8)
    params = params_dict(tmodels.init(torch.Generator().manual_seed(0), cfg, device="cpu"))
    skeleton = transformer.Model(None, cfg, "meta")
    batch = _batch(cfg)
    other = TokenPipeline(cfg.vocab_size, B, S, seed=4).make_batch(0)
    with torch.no_grad(), tmoe.record_routing() as replayed:
        torch.func.functional_call(skeleton, params, (tmodels.forward_hidden, other, cfg))
    with torch.no_grad(), tmoe.record_routing() as own:
        torch.func.functional_call(skeleton, params, (tmodels.forward_hidden, batch, cfg))
    assert not all(torch.equal(a.experts, b.experts) for a, b in zip(replayed, own))
    grads = {}
    for remat in (True, False):
        c = dataclasses.replace(cfg, remat=remat)
        leaves = {name: p.detach().requires_grad_(True) for name, p in params.items()}
        with tmoe.replay_routing(replayed), tmoe.record_routing() as seen:
            loss, _ = torch.func.functional_call(skeleton, leaves, (tmodels.lm_loss, batch, c))
        grads[remat] = torch.autograd.grad(loss, list(leaves.values()))
        assert len(seen) == cfg.n_layers
        assert all(torch.equal(a.experts, b.experts) for a, b in zip(seen, replayed))
    assert all(torch.equal(a, b) for a, b in zip(grads[True], grads[False]))


@pytest.mark.parametrize("arch", MOE)
def test_converter_round_trip(runs, arch):
    tree = runs[arch]["tree"]
    back = convert.model_params_to_numpy(runs[arch]["model"])
    flat, treedef = jax.tree_util.tree_flatten(tree)
    flat_back, treedef_back = jax.tree_util.tree_flatten(back)
    assert treedef == treedef_back
    for a, b in zip(flat, flat_back):
        np.testing.assert_array_equal(a, b)
    bad = {**tree, "periods": {"blocks": [dict(blk) for blk in tree["periods"]["blocks"]]}}
    moe_block = next(blk for blk in bad["periods"]["blocks"] if "moe" in blk)
    moe_block["moe"] = {("up_cs" if k == "up_es" else k): v for k, v in moe_block["moe"].items()}
    with pytest.raises(KeyError):
        convert.model_params_from_numpy(bad, runs[arch]["cfg"], device="cpu")


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "jamba-v0.1-52b"])
def test_port_checkpoint_restores_in_the_reference_layout(runs, arch, tmp_path):
    """A MoE model's parameters, written by the port's ``save_pytree`` in
    the reference's tree (``convert.model_params_to_numpy``), restore
    through the reference's ``restore_pytree`` into its own ``init`` tree
    bit for bit."""
    tree = convert.model_params_to_numpy(runs[arch]["model"])
    path = save_pytree(jax.tree_util.tree_map(torch.as_tensor, tree), str(tmp_path), step=1)
    got = j_restore(runs[arch]["params"], path)
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(runs[arch]["tree"])):
        np.testing.assert_array_equal(np.asarray(a), b)
