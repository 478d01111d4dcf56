"""The ranks' side of ``tests/test_torch_sharding.py`` (imports no JAX).

:func:`all_cases` runs on every rank of one world of CPU gloo ranks: each
serving case on its mesh (the reference's parameter tree carried at the
case's tensor-parallel degree, distributed by ``launch.mesh``), the
sharded AdamW step against the unsharded one, and K9's and K10's custom
ops on DTensors against the ops on whole tensors.  Rank 0's results come
back as numpy.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

B, S, MAX_LEN, DECODE = 4, 16, 24, 4


def _cfg(case):
    from repro_torch.configs import get_smoke_config

    return dataclasses.replace(get_smoke_config(case["arch"]), **case.get("overrides", {}))


def serve_case(case):
    """Prefill ``S`` tokens and ``DECODE`` teacher-forced decode steps on
    the case's mesh: the last prefill logits and each step's, whole."""
    from repro_torch import convert, models
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import sharding as shd

    cfg = _cfg(case)
    mesh = mesh_lib.make_model_mesh(case["mesh"], device_type="cpu")
    env = mesh_lib.bind(mesh)
    try:
        model = convert.model_params_from_numpy(case["tree"], cfg, tp=case["mesh"][1],
                                                device="cpu")
        model = convert.distribute(model, mesh, env)
        tokens = torch.as_tensor(case["tokens"].astype(np.int64))
        state = mesh_lib.distribute_decode_state(
            mesh, models.init_decode_state(cfg, B, MAX_LEN, case["mesh"][1], device="cpu"), env)
        state, last = models.prefill(model, mesh_lib.distribute_batch(
            mesh, {"tokens": tokens}, env), state, cfg)
        steps = []
        for t in range(DECODE):
            tok = mesh_lib.distribute_batch(mesh, {"t": tokens[:, t : t + 1]}, env)["t"]
            logits, state = models.decode_step(model, tok, state, cfg)
            steps.append(logits.full_tensor().numpy())
        return {"last": last.full_tensor().numpy(), "steps": np.stack(steps),
                "placements": {name: str(p.placements) for name, p in model.named_parameters()}}
    finally:
        shd.set_axis_env(None)


def train_case(case):
    """One AdamW step (and the gradients) sharded on the case's mesh and
    unsharded, from the same parameters and batch: the losses and each
    leaf's largest gap and scale."""
    from repro_torch import convert
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import steps
    from repro_torch.models import sharding as shd

    cfg = _cfg(case)
    tp = case["mesh"][1]
    model = convert.model_params_from_numpy(case["tree"], cfg, tp=tp, device="cpu")
    whole = copy.deepcopy(model)
    batch = {k: torch.as_tensor(v.astype(np.int64)) for k, v in case["batch"].items()}
    step = steps.make_train_step(cfg, tp=tp)
    params = steps.params_dict(whole)
    want_p, _, want_m = step(params, steps.init_opt_state(params), batch)
    _, _, want_g = steps.loss_and_grads(cfg, params, batch)
    mesh = mesh_lib.make_model_mesh(case["mesh"], device_type="cpu")
    env = mesh_lib.bind(mesh)
    try:
        params = steps.params_dict(convert.distribute(model, mesh, env))
        sharded = mesh_lib.distribute_batch(mesh, batch, env)
        got_p, opt, got_m = step(params, steps.init_opt_state(params), sharded)
        _, _, got_g = steps.loss_and_grads(cfg, params, sharded)

        def gaps(got, want):
            return {k: (float((got[k].full_tensor() - want[k]).abs().max()),
                        float(want[k].abs().max())) for k in want}

        return {"loss": (float(got_m["loss"].full_tensor()), float(want_m["loss"])),
                "params": gaps(got_p, want_p), "grads": gaps(got_g, want_g),
                "layout": {k: (str(p.placements), str(got_p[k].placements), str(opt.mu[k].placements))
                           for k, p in params.items()}}
    finally:
        shd.set_axis_env(None)


def op_case():
    """K9's and K10's ops (serving, differentiated) on DTensors split by
    batch and heads on a (2, 2) mesh against the same ops on whole
    tensors: the largest gaps, and the placements that came out."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.launch import mesh as mesh_lib

    mesh = mesh_lib.make_model_mesh((2, 2), device_type="cpu")

    def dist(t, placements):
        return distribute_tensor(t, mesh, placements, src_data_rank=None).requires_grad_(
            t.requires_grad)

    g = torch.Generator().manual_seed(0)
    out = {}
    q, k, v = (torch.randn(2, 4, 32, 16, generator=g) for _ in range(3))
    heads = (Shard(0), Shard(1))
    got = fa.flash_attention_op(dist(q, heads), dist(k, heads), dist(v, heads), causal=True)
    out["attn"] = (float((got.full_tensor() - fa.flash_attention_op(q, k, v, causal=True))
                         .abs().max()), str(got.placements))
    whole = [t.clone().requires_grad_() for t in (q, k, v)]
    fa.flash_attention_differentiable(*whole, causal=True).square().sum().backward()
    shards = [dist(t.detach(), heads).requires_grad_() for t in (q, k, v)]
    fa.flash_attention_differentiable(*shards, causal=True).square().sum().backward()
    out["attn_grad"] = max(float((a.grad.full_tensor() - b.grad).abs().max())
                           for a, b in zip(shards, whole))
    # Six query heads over three KV heads, all laid out by heads: split over
    # "model", the second rank's query heads would read KV heads of the
    # first, so the rule must not split the heads.
    q6, k3, v3 = (torch.randn(2, n, 32, 16, generator=g) for n in (6, 3, 3))
    got = fa.flash_attention_op(dist(q6, heads), dist(k3, heads), dist(v3, heads), causal=True)
    out["attn_gqa"] = (float((got.full_tensor() - fa.flash_attention_op(q6, k3, v3, causal=True))
                             .abs().max()), str(got.placements))

    b, l, h, p, n = 2, 40, 4, 8, 16
    x = torch.randn(b, l, h, p, generator=g)
    dt = torch.rand(b, l, h, generator=g) * 0.1
    a = -torch.rand(h, generator=g)
    bm, cm = (torch.randn(b, l, 1, n, generator=g) for _ in range(2))
    layout = ((Shard(0), Shard(2)), (Shard(0), Shard(2)), (Replicate(), Shard(0)),
              (Shard(0), Replicate()), (Shard(0), Replicate()))
    want, want_h = ss.ssd_scan_op(x, dt, a, bm, cm, chunk=16, return_state=True)
    y, hs = ss.ssd_scan_op(*(dist(t, pl) for t, pl in zip((x, dt, a, bm, cm), layout)),
                           chunk=16, return_state=True)
    out["ssd"] = (float((y.full_tensor() - want).abs().max()),
                  float((hs.full_tensor() - want_h).abs().max()), str(hs.placements))
    whole = [t.clone().requires_grad_() for t in (x, dt, a, bm, cm)]
    ss.ssd_differentiable(*whole, chunk=16)[0].square().sum().backward()
    shards = [dist(t.detach(), pl).requires_grad_() for t, pl in zip((x, dt, a, bm, cm), layout)]
    with implicit_replication():  # autograd's zero gradient of the unused final state
        ss.ssd_differentiable(*shards, chunk=16)[0].square().sum().backward()
    out["ssd_grad"] = [(float((s.grad.full_tensor() - w.grad).abs().max()),
                        float(w.grad.abs().max())) for s, w in zip(shards, whole)]
    return out


def all_cases(serve, train):
    """Every case of the module on this rank (``serve``: a list of serving
    cases, ``train``: the AdamW case), on one torch thread (SMOKE widths)."""
    torch.set_num_threads(1)
    return {"serve": [serve_case(case) for case in serve], "train": train_case(train),
            "ops": op_case()}
