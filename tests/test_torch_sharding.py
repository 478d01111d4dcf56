"""The sharding layouts against the live JAX reference.

* **Shapes.** Every registry architecture at SMOKE and at full width, at
  tensor-parallel degree 1, 2, 4 and 16: the port's parameters and decode
  caches (on the meta device) against the reference's ``jax.eval_shape``
  of ``init(..., tp=)`` and ``init_decode_state(..., tp)``, leaf for leaf
  through ``convert``'s names.
* **Specs.** ``launch.mesh.param_shardings``, ``batch_shardings`` and
  ``decode_state_shardings`` against the reference's for every
  architecture at the meshes (1, 1), (4, 1), (16, 16) and (2, 16, 16),
  every shape (``long_500k``'s replicated batch and sequence-sharded
  caches included): the reference on a ``jax.sharding.Mesh`` of one CPU
  device repeated, the port on a fake process group.  A stacked reference
  leaf's spec loses its period axis.
* **Numbers.** One world of 4 CPU gloo ranks for the module
  (``tests/torch_sharding_cases.py``) runs SMOKE qwen1.5, mamba2 and olmoe
  on a (2, 2) mesh and qwen1.5 on a (1, 4) one, a case with padded query
  heads (6 → 8 at tp 4, KV replicated) and one with replicated KV heads
  (2 over tp 4): prefill and 4 teacher-forced decode steps against the
  reference's unsharded run of the same tp tree, at
  ``tests/test_torch_models.py``'s bars (2e-4 / 5e-4).  One sharded AdamW
  step of SMOKE qwen1.5 against the port's unsharded step: the loss to
  1e-5 relative and the parameters to 1e-5 absolute
  (``tests/test_torch_train.py``'s bars), each gradient to 2e-4 of its
  leaf's scale.  K9's and K10's custom ops on DTensors split by batch and
  heads against the ops on whole tensors (their sharding rules): each
  rank runs the plain version on its shard, so the forward is bit for bit.
* **The dry-run.** qwen1.5-0.5b ``decode_32k`` on four cards, (4, 1): a
  rank's parameter bytes are a quarter of one card's apart from the
  replicated leaves, and its collectives are counted.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_sharding_cases as cases  # noqa: E402
from repro import models as jmodels  # noqa: E402
from repro.configs import registry as jregistry  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import models as tmodels  # noqa: E402
from repro_torch.configs import registry as tregistry  # noqa: E402
from repro_torch.launch import dryrun, run_ranks  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import sharding as shd  # noqa: E402

ARCHS = list(tregistry.ARCH_IDS)
TPS = (1, 2, 4, 16)
MESHES = {"1x1": ((1, 1), ("data", "model")), "4x1": ((4, 1), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
TIGHT = dict(rtol=2e-4, atol=5e-4)
SPAWN_TIMEOUT_S = 120.0
_SHAPES = {}  # (arch, preset, tp) -> the reference's abstract parameters


def _get(preset):
    return "get_smoke_config" if preset == "smoke" else "get_config"


def _ref_params(arch, preset, tp):
    key = (arch, preset, tp)
    if key not in _SHAPES:
        cfg = getattr(jregistry, _get(preset))(arch)
        _SHAPES[key] = jax.eval_shape(lambda k: jmodels.init(k, cfg, tp=tp),
                                      jax.ShapeDtypeStruct((2,), jnp.uint32))
    return _SHAPES[key]


def _port_names(tree, cfg, leaf):
    """``tree`` (the reference's parameter structure) keyed by the port's
    parameter names, each leaf as ``leaf(reference leaf, stacked)`` maps
    it (a stacked leaf's value repeated over its periods)."""

    def one(value, count):
        out = np.empty(() if count is None else (count,), dtype=object)
        for i in np.ndindex(out.shape):
            out[i] = value
        return out

    def walk(t, count, top):
        if isinstance(t, dict):
            return {k: walk(v, (cfg.encoder_layers if top == "encoder" else
                                cfg.n_layers // cfg.period()) if k == "periods" else count,
                            k if top is None else top)
                    for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [walk(v, count, top) for v in t]
        return one(leaf(t, count is not None), count)

    return {k: v.item() if isinstance(v, np.ndarray) and v.ndim == 0 else v
            for k, v in convert.model_state_from_numpy(walk(tree, None, None), cfg).items()}


# ---------------------------------------------------------------------------
# (a) shapes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tp", TPS)
@pytest.mark.parametrize("preset", ["smoke", "config"])
@pytest.mark.parametrize("arch", ARCHS)
def test_parameter_and_cache_shapes_match_reference(arch, preset, tp):
    jcfg = getattr(jregistry, _get(preset))(arch)
    tcfg = getattr(tregistry, _get(preset))(arch)
    want = _port_names(_ref_params(arch, preset, tp), tcfg,
                       lambda t, stacked: tuple(t.shape[1:] if stacked else t.shape))
    model = tmodels.transformer.Model(None, tcfg, "meta", tp)
    got = {name: tuple(p.shape) for name, p in model.named_parameters()}
    assert got == want

    jstate = jax.eval_shape(lambda: jmodels.init_decode_state(jcfg, 2, 64, tp))
    state = tmodels.init_decode_state(tcfg, 2, 64, tp, device="meta")
    period = tcfg.period()
    assert len(state.caches) == tcfg.n_layers
    for layer, cache in enumerate(state.caches):
        jcache = jstate.caches[layer % period]
        for field in cache._fields:
            if field == "length":
                continue
            assert tuple(getattr(cache, field).shape) == getattr(jcache, field).shape[1:], (
                layer, field)


# ---------------------------------------------------------------------------
# (b) specs
# ---------------------------------------------------------------------------


def _ref_mesh(shape, axes):
    cpu = jax.devices("cpu")[0]
    return jax.sharding.Mesh(np.array([cpu] * int(np.prod(shape)), dtype=object)
                             .reshape(shape), axes)


def _spec(ps) -> tuple:
    return tuple(None if e is None else e if isinstance(e, str) else tuple(e) for e in ps)


def _trim(spec, ndim):
    """A spec padded with ``None`` to ``ndim`` entries (PartitionSpec drops
    none, ours may be shorter than the rank)."""
    return tuple(spec) + (None,) * (ndim - len(spec))


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_shardings_match_reference(arch, mesh_name):
    shape, axes = MESHES[mesh_name]
    sizes = dict(zip(axes, shape))
    tp, dp = sizes["model"], sizes.get("pod", 1) * sizes["data"]
    jcfg, tcfg = jregistry.get_config(arch), tregistry.get_config(arch)
    jm = _ref_mesh(shape, axes)
    params_s = _ref_params(arch, "config", tp)
    with dryrun.fake_world(int(np.prod(shape))):
        tm = tmesh.make_model_mesh(shape, axes, device_type="cpu")
        model = tmodels.transformer.Model(None, tcfg, "meta", tp)
        for sname, sh in tregistry.SHAPES.items():
            ok = sh.global_batch % dp == 0
            jenv = jmesh.axis_env_for(jm, batch_shardable=ok)
            tenv = tmesh.axis_env_for(tm, batch_shardable=ok)
            assert tenv == {k: v for k, v in jenv.items()}

            want = _port_names(jmesh.param_shardings(jm, params_s, jenv), tcfg,
                               lambda s, stacked: _spec(s.spec)[1:] if stacked else _spec(s.spec))
            got = tmesh.param_shardings(tm, model, tenv)
            params = dict(model.named_parameters())
            assert set(got) == set(want)
            for name, placements in got.items():
                ndim = params[name].dim()
                assert shd.spec_of(placements, axes, ndim) == _trim(want[name], ndim), (
                    sname, name)

            jbatch = jsteps.input_specs(jcfg, jregistry.SHAPES[sname])
            jb = jmesh.batch_shardings(jm, jbatch, jenv)
            tb = tmesh.batch_shardings(tm, tsteps.input_specs(tcfg, sh), tenv)
            assert set(tb) == set(jb)
            for k, placements in tb.items():
                ndim = len(jbatch[k].shape)
                assert shd.spec_of(placements, axes, ndim) == _trim(_spec(jb[k].spec), ndim), k

            if sh.kind == "train" or not tregistry.shape_applicable(tcfg, sh)[0]:
                continue
            _check_state_shardings(jcfg, tcfg, sh, jm, jenv, tm, tenv, tp, axes, params_s)


def _check_state_shardings(jcfg, tcfg, sh, jm, jenv, tm, tenv, tp, axes, params_s):
    jsh = jregistry.SHAPES[sh.name]
    if sh.kind == "prefill":
        jstate = jax.eval_shape(lambda: jmodels.init_decode_state(jcfg, sh.global_batch,
                                                                  sh.seq_len))
        tstate = tmodels.init_decode_state(tcfg, sh.global_batch, sh.seq_len, tp, device="meta")
    elif jcfg.is_encdec:
        _, build = jsteps.decode_state_specs(jcfg, jsh)
        jstate = jax.eval_shape(build, params_s)
        tstate = tsteps.decode_state_specs(tcfg, sh, tp=tp)
    else:
        jstate, _ = jsteps.decode_state_specs(jcfg, jsh)
        tstate = tsteps.decode_state_specs(tcfg, sh, tp=tp)
    want = jmesh.decode_state_shardings(jm, jstate, jenv)
    got = tmesh.decode_state_shardings(tm, tstate, tenv)
    period = tcfg.period()
    for layer, (cache, pcache) in enumerate(zip(tstate.caches, got.caches)):
        jcache = want.caches[layer % period]
        for field in cache._fields:
            if field == "length":
                continue
            ndim = getattr(cache, field).dim()
            assert shd.spec_of(getattr(pcache, field), axes, ndim) == _trim(
                _spec(getattr(jcache, field).spec)[1:], ndim), (sh.name, layer, field)
    if tstate.memory is not None:
        for layer, pair in enumerate(got.memory):
            jpair = want.memory[layer % period]
            for placements, js in zip(pair, jpair):
                assert shd.spec_of(placements, axes, 4) == _trim(_spec(js.spec)[1:], 4), layer


# ---------------------------------------------------------------------------
# (c) numbers on 4 CPU ranks
# ---------------------------------------------------------------------------

SERVE_CASES = {
    "qwen1.5-2x2": ("qwen1.5-0.5b", (2, 2), {}),
    "mamba2-2x2": ("mamba2-1.3b", (2, 2), {}),
    "olmoe-2x2": ("olmoe-1b-7b", (2, 2), {}),
    "qwen1.5-1x4": ("qwen1.5-0.5b", (1, 4), {}),
    "padded-heads-1x4": ("qwen1.5-0.5b", (1, 4), {"n_heads": 6, "n_kv_heads": 2, "d_head": 16}),
    "replicated-kv-1x4": ("qwen1.5-0.5b", (1, 4), {"n_kv_heads": 2}),
}


def _jcfg(arch, overrides):
    return dataclasses.replace(jregistry.get_smoke_config(arch), **overrides)


def _tree(cfg, tp):
    params = jmodels.init(jax.random.PRNGKey(0), cfg, tp=tp)
    return jax.tree_util.tree_map(np.asarray, params)


def _reference_serve(cfg, tree, tokens, tp):
    """The reference's unsharded prefill and teacher-forced decode steps
    of the tp tree."""
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    jtok = jnp.asarray(tokens)
    state = jmodels.init_decode_state(cfg, cases.B, cases.MAX_LEN, tp)
    state, last = jmodels.prefill(params, {"tokens": jtok}, state, cfg)
    steps = []
    for t in range(cases.DECODE):
        logits, state = jmodels.decode_step(params, jtok[:, t : t + 1], state, cfg)
        steps.append(np.asarray(logits))
    return {"last": np.asarray(last), "steps": np.stack(steps)}


@pytest.fixture(scope="module")
def world():
    """The reference's runs, then every case on one spawn of 4 ranks."""
    serve, refs = [], {}
    for name, (arch, mesh, overrides) in SERVE_CASES.items():
        cfg = _jcfg(arch, overrides)
        tree = _tree(cfg, mesh[1])
        tokens = np.random.default_rng(1).integers(
            0, cfg.vocab_size, (cases.B, cases.S)).astype(np.int32)
        refs[name] = _reference_serve(cfg, tree, tokens, mesh[1])
        serve.append({"arch": arch, "mesh": mesh, "overrides": overrides, "tree": tree,
                      "tokens": tokens})
    cfg = jregistry.get_smoke_config("qwen1.5-0.5b")
    rng = np.random.default_rng(2)
    batch = {k: rng.integers(0, cfg.vocab_size, (cases.B, 32)).astype(np.int32)
             for k in ("tokens", "labels")}
    train = {"arch": "qwen1.5-0.5b", "mesh": (2, 2), "tree": _tree(cfg, 2), "batch": batch}
    out = run_ranks(cases.all_cases, 4, backend="gloo", device="cpu", args=(serve, train),
                    timeout_s=SPAWN_TIMEOUT_S)
    out["refs"] = refs
    out["serve"] = dict(zip(SERVE_CASES, out["serve"]))
    return out


@pytest.mark.parametrize("case", list(SERVE_CASES))
def test_sharded_serving_matches_reference(world, case):
    got, want = world["serve"][case], world["refs"][case]
    assert got["last"].shape == want["last"].shape
    np.testing.assert_allclose(got["last"], want["last"], **TIGHT)
    np.testing.assert_allclose(got["steps"], want["steps"], **TIGHT)


def test_sharded_layouts_are_the_specs(world):
    """The padded-heads case's parameters came out as its specs say:
    query heads over ``model``, the KV projections (replicated heads) not,
    ZeRO over ``data`` (size 1 on a (1, 4) mesh: a Shard there is the
    whole), a layer's vectors included, the final norm's not."""
    pl = world["serve"]["padded-heads-1x4"]["placements"]
    assert pl["blocks.0.attn.wq"] == "(Shard(dim=0), Shard(dim=1))"
    assert pl["blocks.0.attn.wk"] == "(Shard(dim=0), Replicate())"
    assert pl["blocks.0.attn.wo"] == "(Shard(dim=1), Shard(dim=0))"
    assert pl["embed.table"] == "(Shard(dim=1), Shard(dim=0))"
    assert pl["blocks.0.mixer_norm.scale"] == "(Shard(dim=0), Replicate())"  # a layer's vector
    assert pl["final_norm.scale"] == "(Replicate(), Replicate())"


def test_sharded_adamw_step_matches_unsharded(world):
    tr = world["train"]
    got, want = tr["loss"]
    assert abs(got - want) <= 1e-5 * abs(want)
    for name, (gap, scale) in tr["grads"].items():
        assert scale > 0 and gap <= 2e-4 * scale, name
    for name, (gap, _) in tr["params"].items():
        assert gap <= 1e-5, name
    for name, (param, new, moment) in tr["layout"].items():
        assert param == new == moment, name  # the step keeps each leaf's layout


def test_custom_op_sharding_rules(world):
    ops = world["ops"]
    assert ops["attn"] == (0.0, "(Shard(dim=0), Shard(dim=1))")
    assert ops["attn_grad"] <= 1e-5
    y_gap, h_gap, h_placements = ops["ssd"]
    assert y_gap == 0.0 and h_gap == 0.0 and h_placements == "(Shard(dim=0), Shard(dim=1))"
    for gap, scale in ops["ssd_grad"]:
        assert gap <= 2e-4 * scale


def test_attention_rule_splits_no_kv_group(world):
    """Heads laid out over a mesh whose size does not divide the KV heads
    (6 query heads over 3 KV heads, 4 ranks) come back whole, not split
    by heads."""
    gap, placements = world["ops"]["attn_gqa"]
    assert gap == 0.0
    assert "Shard(dim=1)" not in placements


# ---------------------------------------------------------------------------
# (d) the dry-run on four cards
# ---------------------------------------------------------------------------


def test_dryrun_four_cards_shards_parameters():
    cfg = tregistry.get_config("qwen1.5-0.5b")
    shape = tregistry.SHAPES["decode_32k"]
    whole = tmodels.transformer.Model(None, cfg, "meta")
    with dryrun.fake_world(4):
        layout = dryrun.Layout("four", shape.global_batch)
        try:
            counts = dryrun.trace_step(cfg, shape, layout)
            specs = tmesh.param_specs(layout.mesh, whole, layout.env)
        finally:
            shd.set_axis_env(None)
    sizes = {name: p.numel() * p.element_size() for name, p in whole.named_parameters()}
    total = sum(sizes.values())
    # The leaves ZeRO leaves whole: those whose every dividing dim is a
    # tensor-parallel one (the model axis has size 1 here) and the final norm.
    replicated = sum(sizes[name] for name, spec in specs.items()
                     if not any("data" in shd._axes(e) for e in spec))
    assert 0 < replicated < total / 100
    assert counts["param_bytes"] == (total - replicated) // 4 + replicated
    assert counts["collectives"]["all-gather"]["count"] > 0
    assert counts["batch_bytes"] == shape.global_batch // 4 * 4  # int32 tokens, a rank's
