"""The encoder–decoder of the PyTorch port against the JAX reference.

seamless-m4t-large-v2 at SMOKE (2 encoder and 2 decoder layers, d 64, f32),
built once from the reference's own parameters (``repro.models.init``,
carried over by ``convert.model_params_from_numpy``), on the same seeded
source frames and tokens; the reference runs jitted under
``attn_impl="interpret"`` (its Pallas kernel in interpret mode) and
``"chunked"``, once for the module.

* ``forward_hidden``, ``prefill`` (last logits, self-attention caches, the
  cross K/V memory) and four ``decode_step`` logits at 2e-4 / 5e-4;
* ``lm_loss`` and every gradient leaf (``encoder.*`` and ``cross_attn.*``
  included) at 1e-5 / 2e-4 of each leaf's max abs, as
  ``tests/test_torch_zoo.py`` holds the decoder-only zoo;
* ``encode_memory`` and ``attn_apply(memory=)`` alone at a one-row query
  (decode's cross-attention);
* the decoder takes no positions; teacher-forced decode against
  ``forward_hidden``; ``cfg.remat`` changes no gradient bit (the encoder's
  blocks checkpointed too); the converter's exact round trip; a float
  source kept float by ``train_batch_from_numpy``; the model at
  ``dtype="bfloat16"`` to the bf16 bar.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import models as jmodels  # noqa: E402
from repro.configs import registry as jregistry  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import models as tmodels  # noqa: E402
from repro_torch.configs import registry as tregistry  # noqa: E402
from repro_torch.launch import (  # noqa: E402
    loss_and_grads,
    make_prefill_step,
    make_serve_step,
    make_train_step,
    params_dict,
)
from repro_torch.launch.steps import init_opt_state  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import transformer  # noqa: E402

ARCH = "seamless-m4t-large-v2"
B, S, MAX_LEN, DECODE = 2, 24, 32, 4
IMPLS = ("interpret", "chunked")
TIGHT = dict(rtol=2e-4, atol=5e-4)
BF16_TOL = dict(rtol=2e-2, atol=5e-2)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _close(got, want, **tol):
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def _batch(cfg, seed=1):
    """Source frames (B, source_len, d) and tokens / labels (B, S), some
    labels masked."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels[0, :5] = -1
    return {"src_embeds": rng.standard_normal((B, cfg.source_len, cfg.d_model)).astype(np.float32),
            "tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            "labels": labels}


def _reference_run(cfg, params, batch):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    hidden, _ = jax.jit(jmodels.forward_hidden, static_argnums=2)(params, jb, cfg)
    state = jmodels.init_decode_state(cfg, B, MAX_LEN)
    state, last = jax.jit(jmodels.prefill, static_argnums=3)(params, jb, state, cfg)
    prefill_state = state
    decode = jax.jit(jmodels.decode_step, static_argnums=3)
    steps = []
    for t in range(DECODE):
        logits, state = decode(params, jb["tokens"][:, t : t + 1], state, cfg)
        steps.append(logits)
    return {"hidden": hidden, "last": last, "prefill_state": prefill_state, "steps": steps}


def _port_run(model, cfg, batch):
    hidden, aux = tmodels.forward_hidden(model, batch, cfg)
    state = tmodels.init_decode_state(cfg, B, MAX_LEN, device="cpu")
    state, last = make_prefill_step(cfg, MAX_LEN)(model, batch, state)
    caches = [tuple(t.clone() if isinstance(t, torch.Tensor) else t for t in c)
              for c in state.caches]
    memory = state.memory
    serve = make_serve_step(cfg)
    steps = []
    for t in range(DECODE):
        logits, state = serve(model, batch["tokens"][:, t : t + 1], state)
        steps.append(logits)
    return {"hidden": hidden, "aux": aux, "last": last, "caches": caches, "memory": memory,
            "steps": steps, "length": state.length}


@pytest.fixture(scope="module")
def run():
    """Both packages on seamless SMOKE, the reference under both lowerings,
    and the reference's loss and gradients (three loss chunks)."""
    jcfg = jregistry.get_smoke_config(ARCH)
    params = jmodels.init(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, params)
    cfg = tregistry.get_smoke_config(ARCH)
    model = convert.model_params_from_numpy(tree, cfg, device="cpu")
    batch = _batch(cfg)
    out = {"params": params, "tree": tree, "model": model, "cfg": cfg, "batch": batch,
           "port": _port_run(model, cfg, batch)}
    for impl in IMPLS:
        out[impl] = _reference_run(dataclasses.replace(jcfg, attn_impl=impl), params, batch)
    lcfg = dataclasses.replace(jcfg, logits_chunk=8)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p, b: jmodels.lm_loss(p, b, lcfg), has_aux=True))(params, jb)
    out["loss"], out["grads"] = float(loss), jax.tree_util.tree_map(np.asarray, grads)
    return out


def test_model_builds_an_encoder_and_cross_blocks(run):
    model, cfg = run["model"], run["cfg"]
    assert len(model.encoder.blocks) == cfg.encoder_layers
    assert all(hasattr(b, "attn") and hasattr(b, "mlp") and not hasattr(b, "cross_attn")
               for b in model.encoder.blocks)
    assert all(hasattr(b, "cross_norm") and hasattr(b, "cross_attn") for b in model.blocks)
    n_params = sum(p.numel() for p in model.parameters())
    assert n_params == sum(np.asarray(a).size for a in jax.tree_util.tree_leaves(run["tree"]))


@pytest.mark.parametrize("impl", IMPLS)
def test_forward_hidden_matches_reference(run, impl):
    got, want = run["port"], run[impl]
    assert got["hidden"].shape == (B, S, run["cfg"].d_model)
    _close(got["hidden"], want["hidden"], **TIGHT)
    assert float(got["aux"]) == 0.0


@pytest.mark.parametrize("impl", IMPLS)
def test_prefill_matches_reference(run, impl):
    got, ref, cfg = run["port"], run[impl], run["cfg"]
    assert got["last"].shape == (B, 1, tlayers.padded_vocab(cfg))
    _close(got["last"], ref["last"], **TIGHT)
    jstate = ref["prefill_state"]
    assert int(jstate.length) == S
    for layer, (k, v, length) in enumerate(got["caches"]):
        jcache = jstate.caches[0]
        assert length == S
        _close(k, jcache.k[layer], **TIGHT)
        _close(v, jcache.v[layer], **TIGHT)
    # The cross K/V: one (k, v) a decoder layer, (B, Hkv, source_len, dh).
    assert len(got["memory"]) == cfg.n_layers
    for layer, (k, v) in enumerate(got["memory"]):
        jk, jv = jstate.memory[0]
        assert k.shape == (B, cfg.n_kv_heads, cfg.source_len, cfg.head_dim)
        _close(k, jk[layer], **TIGHT)
        _close(v, jv[layer], **TIGHT)


@pytest.mark.parametrize("impl", IMPLS)
def test_decode_steps_match_reference(run, impl):
    got, ref = run["port"], run[impl]
    assert got["length"] == S + DECODE
    for g, w in zip(got["steps"], ref["steps"]):
        _close(g, w, **TIGHT)


def test_lm_loss_and_every_gradient_leaf_match_reference(run):
    cfg = dataclasses.replace(run["cfg"], logits_chunk=8)
    params = convert.train_params_from_numpy(run["tree"], cfg, device="cpu")
    loss, metrics, grads = loss_and_grads(cfg, params, run["batch"])
    assert abs(float(loss) - run["loss"]) <= 1e-5 * abs(run["loss"])
    assert int(metrics["tokens"]) == B * S - 5
    want = convert.model_state_from_numpy(run["grads"], cfg)
    assert set(want) == set(grads)
    assert any(name.startswith("encoder.blocks.") for name in grads)
    assert any(".cross_attn." in name for name in grads)
    for name, g in grads.items():
        scale = np.abs(want[name]).max()
        assert scale > 0, name
        assert np.abs(g.numpy() - want[name]).max() <= 2e-4 * scale, name


@pytest.mark.parametrize("impl", IMPLS)
def test_encode_memory_and_one_row_cross_attention(run, impl):
    """Decode's cross-attention alone: the memory of an encoder output and
    one new query row against it, each against the reference's."""
    jcfg = dataclasses.replace(jregistry.get_smoke_config(ARCH), attn_impl=impl)
    cfg = run["cfg"]
    rng = np.random.default_rng(7)
    enc = rng.standard_normal((B, cfg.source_len, cfg.d_model)).astype(np.float32)
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    jp = run["params"]["periods"]["blocks"][0]["cross_attn"]
    jp = jax.tree_util.tree_map(lambda leaf: leaf[1], jp)  # decoder layer 1
    block = run["model"].blocks[1].cross_attn
    jk, jv = jattn.encode_memory(jp, jnp.asarray(enc), jcfg)
    k, v = tattn.encode_memory(block, torch.as_tensor(enc), cfg)
    assert k.is_contiguous() and v.is_contiguous()
    _close(k, jk, **TIGHT)
    _close(v, jv, **TIGHT)
    jout, _ = jattn.attn_apply(jp, jnp.asarray(x), jcfg, causal=False, memory=(jk, jv))
    out, new_cache = tattn.attn_apply(block, torch.as_tensor(x), cfg, causal=False,
                                      memory=(k, v))
    assert new_cache is None and out.shape == (B, 1, cfg.d_model)
    _close(out, jout, **TIGHT)


def test_decoder_takes_no_positions(run, monkeypatch):
    """The reference adds sinusoidal positions to the encoder alone: the
    decoder-only helper never runs for an encoder–decoder, in any mode."""
    model, cfg, batch = run["model"], run["cfg"], run["batch"]

    def refuse(*_a, **_kw):
        raise AssertionError("decoder positions added")

    monkeypatch.setattr(transformer, "_add_positions", refuse)
    hidden, _ = tmodels.forward_hidden(model, batch, cfg)
    state = tmodels.init_decode_state(cfg, B, MAX_LEN, device="cpu")
    state, last = tmodels.prefill(model, batch, state, cfg)
    logits, _ = tmodels.decode_step(model, batch["tokens"][:, :1], state, cfg)
    torch.testing.assert_close(hidden, run["port"]["hidden"], rtol=0, atol=0)
    torch.testing.assert_close(logits, run["port"]["steps"][0], rtol=0, atol=0)


def test_teacher_forced_decode_matches_forward(run):
    """The KV-cache invariant with the memory carried: decode steps from an
    empty cache, each token in turn, give ``forward_hidden``'s logits."""
    model, cfg, batch = run["model"], run["cfg"], run["batch"]
    hidden, _ = tmodels.forward_hidden(model, batch, cfg)
    full = hidden @ tlayers.lm_head_weights(model.embed, cfg)
    memory = transformer._cross_memory(model, transformer._encode(model, batch, cfg), cfg)
    state = tmodels.init_decode_state(cfg, B, S, device="cpu")._replace(memory=memory)
    steps = []
    for t in range(S):
        logits, state = tmodels.decode_step(model, batch["tokens"][:, t : t + 1], state, cfg)
        steps.append(logits[:, 0])
    _close(torch.stack(steps, dim=1), full, **TIGHT)


def test_remat_changes_no_gradient_bit(run, monkeypatch):
    """One checkpoint a block, the encoder's included; gradients (the
    encoder's, reached through the checkpointed cross blocks) equal those
    without remat bit for bit."""
    cfg = dataclasses.replace(run["cfg"], logits_chunk=8)
    assert cfg.remat
    params = convert.train_params_from_numpy(run["tree"], cfg, device="cpu")
    calls = []
    real = transformer.checkpoint
    monkeypatch.setattr(transformer, "checkpoint",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    loss_on, _, on = loss_and_grads(cfg, params, run["batch"])
    assert len(calls) == cfg.encoder_layers + cfg.n_layers
    loss_off, _, off = loss_and_grads(dataclasses.replace(cfg, remat=False), params,
                                      run["batch"])
    assert len(calls) == cfg.encoder_layers + cfg.n_layers
    assert torch.equal(loss_on, loss_off)
    assert all(torch.equal(on[name], off[name]) for name in on)
    assert all(float(on[name].abs().max()) > 0 for name in on if name.startswith("encoder."))


def test_converter_round_trip(run):
    tree = run["tree"]
    back = convert.model_params_to_numpy(convert.model_params_from_numpy(tree, run["cfg"],
                                                                         device="cpu"))
    flat, treedef = jax.tree_util.tree_flatten(tree)
    flat_back, treedef_back = jax.tree_util.tree_flatten(back)
    assert treedef == treedef_back
    for a, b in zip(flat, flat_back):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(KeyError):
        bad = {**tree, "encoder": {**tree["encoder"], "final_norm": {
            "scale_rs": tree["encoder"]["final_norm"]["scale"]}}}
        convert.model_params_from_numpy(bad, run["cfg"], device="cpu")


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_train_batch_keeps_a_float_source_float(run, dtype):
    batch = run["batch"]
    got = convert.train_batch_from_numpy(batch, dtype=dtype, device="cpu")
    assert got["tokens"].dtype == got["labels"].dtype == torch.int64
    assert got["src_embeds"].dtype == (dtype or torch.float32)
    want = torch.as_tensor(batch["src_embeds"]).to(dtype or torch.float32)
    assert torch.equal(got["src_embeds"], want)
    bf16 = np.asarray(jnp.asarray(batch["src_embeds"], jnp.bfloat16))
    got = convert.train_batch_from_numpy({"src_embeds": bf16}, device="cpu")["src_embeds"]
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.float(), torch.as_tensor(bf16.astype(np.float32)))


def test_train_step_takes_a_source(run):
    """``make_train_step`` on an encoder–decoder batch: a finite loss, and
    AdamW moves the encoder's and the cross blocks' parameters."""
    cfg = run["cfg"]
    params = params_dict(run["model"])
    step = make_train_step(cfg, lr=1e-3)
    batch = convert.train_batch_from_numpy(run["batch"], device="cpu")
    new, _, metrics = step(params, init_opt_state(params), batch)
    assert np.isfinite(float(metrics["loss"]))
    for name in ("encoder.blocks.0.attn.wq", "encoder.final_norm.scale",
                 "blocks.1.cross_attn.wk", "blocks.0.cross_norm.bias"):
        assert not torch.equal(new[name], params[name]), name


def test_bf16_serving_matches_reference(run):
    """seamless SMOKE at ``dtype="bfloat16"`` (f32 parameters, as at full
    width): forward, prefill and the decode steps at the bf16 bar."""
    jcfg = dataclasses.replace(jregistry.get_smoke_config(ARCH), dtype="bfloat16")
    cfg = dataclasses.replace(run["cfg"], dtype="bfloat16")
    ref = _reference_run(jcfg, run["params"], run["batch"])
    got = _port_run(run["model"], cfg, run["batch"])
    assert got["hidden"].dtype == torch.bfloat16
    assert got["memory"][0][0].dtype == torch.bfloat16
    _close(got["hidden"], ref["hidden"], **BF16_TOL)
    _close(got["last"], ref["last"], **BF16_TOL)
    for g, w in zip(got["steps"], ref["steps"]):
        _close(g, w, **BF16_TOL)
