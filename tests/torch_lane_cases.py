"""The lane-axis step arms of K1, K6, K2 and K7 against their one-lane arms.

Shared by ``tests/test_torch_cuda.py``, ``tests/test_torch_batch_lsq.py``
and ``chip_smoke.py`` (no JAX).  :func:`lane_step_inputs` builds B lanes
of one def-CG iteration's inputs in the layout the batched loops hand the
kernels: vectors ``(B, n)``, bases ``(B, k, n)``, the per-lane scalars as
strided views of packed buffers (``so[:, 0]``-style, as a previous step's
outputs are), a mix of live, frozen, indefinite and diverging lanes.
:func:`run_lane_arms` runs K1's step, K6's step and K2's step on the lane
axis and then each lane alone through the one-lane arms on that lane's
views; :func:`lane_mismatches` names every output that differs in a bit.
:func:`lsmr_lane_inputs` and :func:`run_lsmr_lane_arms` do the same for
K7's step arm (one LSMR iteration's tail): live, frozen, converging,
diverging and exactly terminating lanes.
"""

from __future__ import annotations

import hashlib


def lane_step_inputs(torch, device, dtype, lanes, n, k, *, mode="plain", seed=0, ell=4,
                     maxiter=10):
    """One def-CG iteration's inputs for ``lanes`` lanes.  ``mode``:
    ``plain`` (no recording), ``recording`` (row 1 of ``ell + 1``-row
    buffers) or ``armed`` (the stall detector, window 4)."""
    g = torch.Generator(device=device).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=device, dtype=dtype)

    x, r, p, ap, z = (rnd(lanes, n) for _ in range(5))
    aw = rnd(lanes, k, n) if k else None
    w = rnd(lanes, k, n) if k else None
    waw_inv = rnd(lanes, k, k) if k else None
    lane = torch.arange(lanes, device=device)
    d = (p * ap).sum(1).abs() + 1.0
    d = torch.where(lane % 7 == 3, -d, d)  # an indefinite lane
    rs = (r * r).sum(1)
    # The per-lane scalars as views of packed buffers: lane strides > 1.
    pack = torch.stack([rs, torch.sqrt(rs), d, 1.5 * torch.sqrt(rs)], 1)
    armed = mode == "armed"
    js = torch.stack([(lane % 5).to(torch.int32), torch.zeros_like(lane, dtype=torch.int32)]
                     + ([(lane % 4).to(torch.int32)] if armed else []), 1).contiguous()
    flags = torch.stack([lane % 3 != 1, lane % 2 == 0], 1)  # a frozen lane in three
    threshold = torch.full((lanes,), 1e-6, dtype=dtype, device=device)
    diverged_at = torch.where(lane % 7 == 5, 1e-30, 1e8).to(dtype)  # a diverging lane
    inputs = dict(x=x, r=r, p=p, ap=ap, z=z, aw=aw, w=w, waw_inv=waw_inv, d=pack[:, 2],
                  rs=pack[:, 0], rnorm=pack[:, 1], js=js, active=flags[:, 0],
                  threshold=threshold, diverged_at=diverged_at, maxiter=maxiter,
                  window=4 if armed else 0, best=pack[:, 3] if armed else None,
                  trace=torch.full((lanes, maxiter + 2), float("nan"), dtype=dtype,
                                   device=device))
    if mode == "recording":
        inputs.update(row=1, a_rows=torch.zeros(lanes, ell + 1, dtype=dtype, device=device),
                      b_rows=torch.zeros(lanes, ell + 1, dtype=dtype, device=device),
                      p_buf=torch.zeros(lanes, ell + 1, n, dtype=dtype, device=device),
                      ap_buf=torch.zeros(lanes, ell + 1, n, dtype=dtype, device=device))
    return inputs


def _buffers(t):
    """Fresh copies of the in-place buffers, so two runs write apart."""
    keys = ("trace", "a_rows", "b_rows", "p_buf", "ap_buf")
    return {key: t[key].clone() for key in keys if t.get(key) is not None}


def run_steps(torch, cf, t, *, one_lane=None, arms="cuda"):
    """K1's step, K6's step and K2's step as the preconditioned def-CG
    loop chains them (K6's α is K1's ``so[2]``, K2's β, μ and keep K6's
    ``so[1], so[2:]`` and K1's ``flags[1]``); on all lanes (``one_lane``
    None) or on lane ``one_lane`` alone through the one-lane arms, with
    that lane's views.  Returns every output and buffer, by name."""
    step = {"cuda": (cf.fused_cg_step_cuda, cf.fused_rz_step_cuda,
                     cf.fused_direction_step_cuda),
            "plain": (cf.fused_cg_step_plain, cf.fused_rz_step_plain,
                      cf.fused_direction_step_plain)}[arms]
    bufs = _buffers(t)
    i = one_lane

    def at(v):
        return v if (i is None or v is None or not isinstance(v, torch.Tensor)) else v[i]

    rec = "row" in t
    # K1 without the recurrence: the preconditioned loop's update arm (the
    # unpreconditioned arm's GEMV rides in the same sums, held by the
    # one-lane tests), then K6 forms rᵀz, β and μ.
    xo, ro, apo, so, jo, bo = step[0](
        at(t["x"]), at(t["r"]), at(t["p"]), at(t["ap"]).clone(), at(t["d"]), at(t["rs"]),
        at(t["rnorm"]), at(t["js"]), at(t["active"]), at(t["threshold"]),
        at(t["diverged_at"]), t["maxiter"], recurrence=False, trace=at(bufs["trace"]),
        window=t["window"], best=at(t["best"]))
    k1r = step[0](
        at(t["x"]), at(t["r"]), at(t["p"]), at(t["ap"]).clone(), at(t["d"]), at(t["rs"]),
        at(t["rnorm"]), at(t["js"]), at(t["active"]), at(t["threshold"]),
        at(t["diverged_at"]), t["maxiter"], at(t["aw"]), at(t["waw_inv"]),
        **({} if not rec else dict(row=t["row"], a_rows=at(bufs["a_rows"]),
                                   b_rows=at(bufs["b_rows"]))),
        window=t["window"], best=at(t["best"]))
    rows = {} if not rec else dict(row=t["row"], a_rows=at(bufs["a_rows"]).clone(),
                                   b_rows=at(bufs["b_rows"]).clone())
    sz = step[1](ro, at(t["z"]), at(t["rs"]), at(t["aw"]), at(t["waw_inv"]),
                 alpha=so[..., 2], active=at(t["active"]), **rows)
    k = 0 if t["w"] is None else t["w"].shape[-2]
    drec = {} if not rec else dict(ap=apo, active=at(t["active"]), row=t["row"],
                                   p_buf=at(bufs["p_buf"]), ap_buf=at(bufs["ap_buf"]))
    po = step[2](at(t["z"]), at(t["p"]), sz[..., 1], bo[..., 1], at(t["w"]),
                 sz[..., 2:2 + k] if k else None, **drec)
    out = dict(xo=xo, ro=ro, apo=apo, so=so, jo=jo, bo=bo, k1r_x=k1r[0], k1r_so=k1r[3],
               k1r_js=k1r[4], k1r_flags=k1r[5], sz=sz, po=po, trace=bufs["trace"])
    if rec:
        out.update(a_rows=bufs["a_rows"], b_rows=bufs["b_rows"], rz_a_rows=rows["a_rows"],
                   rz_b_rows=rows["b_rows"], p_buf=bufs["p_buf"], ap_buf=bufs["ap_buf"])
    return out


def run_lane_arms(torch, cf, t, arms="cuda"):
    """``(lane_out, per_lane_outs)``: the lane-axis launches, and each lane
    through the one-lane arms (its outputs stacked, its in-place buffers
    the rows it wrote)."""
    lanes = t["x"].shape[0]
    full = run_steps(torch, cf, t, arms=arms)
    singles = [run_steps(torch, cf, t, one_lane=i, arms=arms) for i in range(lanes)]
    stacked = {}
    for key in full:
        if key in ("trace", "a_rows", "b_rows", "p_buf", "ap_buf"):
            stacked[key] = torch.stack([s[key][i] for i, s in enumerate(singles)])
        else:
            stacked[key] = torch.stack([s[key] for s in singles])
    return full, stacked


def _bits(torch, t):
    if t.dtype == torch.bool:
        return t.to(torch.uint8)
    if t.dtype == torch.int32:
        return t
    return t.view(torch.int64 if t.element_size() == 8 else torch.int32)


def lane_mismatches(torch, a, b):
    """The names of the outputs whose bits differ between two runs."""
    return [key for key in a if not torch.equal(_bits(torch, a[key]), _bits(torch, b[key]))]


def digest(torch, outs) -> str:
    """SHA-256 of every output's bytes, in key order."""
    h = hashlib.sha256()
    for key in sorted(outs):
        h.update(key.encode())
        h.update(_bits(torch, outs[key].contiguous()).cpu().numpy().tobytes())
    return h.hexdigest()


# ---------------------------------------------------------------------------
# K7: the LSMR step arm
# ---------------------------------------------------------------------------

LSMR_CASES = ("live", "frozen", "converging", "diverging", "exact")
# lsmr_step's positional inputs, in order.
LSMR_ARGS = ("x", "hbar", "h", "v", "w", "wsq", "beta", "s", "js", "active", "threshold",
             "diverged_at", "maxiter")


def lsmr_lane_inputs(torch, device, dtype, lanes, n, *, window=0, seed=0, maxiter=10):
    """One LSMR iteration's tail inputs for ``lanes`` lanes, lane i of case
    ``LSMR_CASES[i % 5]``: live; frozen (``active`` false); converging (its
    threshold above any |ζ̄|, so the next active flag drops); diverging
    (``diverged_at`` below it: STAGNATED); exact (β⁺ = 0: the latch).  The
    carried scalars ``s`` are rows of a wider packed buffer and the other
    per-lane scalars strided views (lane strides > 1), as the loop hands
    them; ``window > 0`` arms the stall detector."""
    g = torch.Generator(device=device).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=device, dtype=dtype)

    x, hbar, h, v, w = (rnd(lanes, n) for _ in range(5))
    lane = torch.arange(lanes, device=device)
    case = lane % len(LSMR_CASES)
    armed = window > 0
    slots = 7 + armed
    packed = rnd(lanes, slots + 3).abs() + 0.1
    s = packed[:, 1:1 + slots]
    wsq = (w * w).sum(1)
    beta = torch.where(case == 4, 0.0, rnd(lanes).abs() + 0.1).to(dtype)
    scal = torch.stack([wsq, beta, torch.where(case == 2, 1e30, 1e-6).to(dtype),
                        torch.where(case == 3, 1e-30, 1e8).to(dtype)], 1)
    js = torch.stack([(lane % 5 + 1).to(torch.int32), torch.zeros_like(lane, dtype=torch.int32)]
                     + ([(lane % 4 + window - 2).to(torch.int32)] if armed else []),
                     1).contiguous()
    flags = torch.stack([case != 1, lane % 2 == 0], 1)
    return dict(x=x, hbar=hbar, h=h, v=v, w=w, wsq=scal[:, 0], beta=scal[:, 1], s=s, js=js,
                active=flags[:, 0], threshold=scal[:, 2], diverged_at=scal[:, 3],
                maxiter=maxiter, window=window,
                trace=torch.full((lanes, maxiter + 2), float("nan"), dtype=dtype,
                                 device=device))


def run_lsmr_steps(torch, cf, t, *, one_lane=None, arms="cuda"):
    """K7's step arm on all lanes (``one_lane`` None) or on lane
    ``one_lane`` alone through the one-lane arm, with that lane's views.
    Returns every output and the trace, by name."""
    step = {"cuda": cf.lsmr_step_cuda, "plain": cf.lsmr_step_plain}[arms]
    trace = t["trace"].clone()
    i = one_lane

    def at(v):
        return v if i is None else v[i]

    out = step(*(at(t[key]) for key in LSMR_ARGS[:-1]), t["maxiter"], at(trace),
               window=t["window"])
    return dict(zip(("xo", "hbo", "ho", "vo", "so", "jo", "ao"), out), trace=trace)


def run_lsmr_lane_arms(torch, cf, t, arms="cuda"):
    """``(lane_out, per_lane_outs)`` of K7's step arm, as
    :func:`run_lane_arms`."""
    lanes = t["x"].shape[0]
    full = run_lsmr_steps(torch, cf, t, arms=arms)
    singles = [run_lsmr_steps(torch, cf, t, one_lane=i, arms=arms) for i in range(lanes)]
    stacked = {key: torch.stack([s[key][i] if key == "trace" else s[key]
                                 for i, s in enumerate(singles)]) for key in full}
    return full, stacked
