"""The def-CG and LSMR hot paths on the H100: six hand-written CUDA kernels.

Each kernel replaces one Pallas TPU kernel of ``repro/kernels/cg_fused.py``;
its CUDA source is ``csrc/cg_fused.cu`` (f32 and f64 instantiations, plain
C interface, built by :mod:`repro_torch.kernels._build`):

* ``fused_cg_update`` replaces ``fused_cg_update_pallas`` (cg_fused.py:122):
  ``x + αp``, ``r − α·ap``, ``‖r_new‖²`` and ``(AW)·r_new`` in one pass.
  Bound on the H100 by bytes: (6 + k)·n elements for ~(6 + 2k)·n flops.
  ONE launch: as many blocks as the card holds at once (occupancy API),
  16-byte loads where every vector is aligned; each block writes its
  k + 1 partial sums, takes an integer ticket, and the block that draws
  the last ticket sums every block's partials in block order (the
  partials and the counter are allocated once per device and dtype).
  Its second arm, ``fused_cg_step``, is def-CG's iteration tail: the
  breakdown test and α before the update, and after it β, μ = (WᵀAW)⁻¹·
  (AW)ᵀr (no preconditioner), √rr, the status, the trace slot, j, the
  next step's active flag and the ``p`` select's mask, in the same launch.
* ``fused_rz_reduce`` replaces ``fused_rz_reduce_pallas`` (cg_fused.py:252):
  ``(rᵀz, (AW)·z)`` in one pass, the preconditioned iteration's second
  sweep (``z = M⁻¹r`` exists only after the residual update).
  Bytes-bound, (2 + k)·n elements for 2(1 + k)·n flops; ONE launch with
  ``fused_cg_update``'s layout and ticket reduction (and its scratch).
  Its step arm, ``fused_rz_step``, is the preconditioned def-CG and cg
  tail: β = rᵀz / safe(rs), μ = (WᵀAW)⁻¹(AW)ᵀz and the recorded α / β,
  in the same launch.  Its pair arm, ``fused_rz_pair``, sums ``rᵀap,
  (AW)·ap, rᵀr, (AW)·r`` in one read for the sharded def-CG, each column
  in the one-vector arm's order (every arm takes the pair arm's grid).
* ``fused_deflate_direction`` replaces ``fused_deflate_direction_pallas``
  (cg_fused.py:426), both arms: ``p ← βp + r − μᵀW`` and, when buffers are
  given, the incoming ``(p, ap)`` written into row ``idx`` of the
  ``(rows, n)`` recording buffers in place.  Bytes-bound, (3 + k)·n
  elements (+3n recording); one grid-stride pass (16-byte groups where
  aligned, the grid from the occupancy API), β and μ in registers, read
  from device memory so the loop never waits on the host.  Its step arm,
  ``fused_direction_step``, is the loops' direction step: a fresh
  ``keep ? p' : p`` (the ``p`` select) and the recording row
  ``active ? row : ell`` formed in the kernel.
* ``self_gram`` replaces ``self_gram_pallas`` (cg_fused.py:558): ``S Sᵀ``
  of the stacked window ``S = [Z; AZ]`` (2m ≤ 128 rows).  Bytes-bound: it
  reads 2m·n elements for m(2m+1)·2n flops.  One block per SM streams its
  column range through shared memory (cp.async, three stages) and adds
  its share of each 8 × 8 tile of the upper triangle in registers: on the
  FP64 tensor cores (DMMA) in f64, by 4 × 4 FMA micro-tiles in f32; a
  second kernel sums the per-block tiles in a fixed order, coalesced, and
  writes both halves from one value.
* ``recombine_blocks`` replaces ``recombine_blocks_pallas``
  (cg_fused.py:639): ``[uᵀZ; uᵀAZ]``.  Bytes-bound, 2(m + k)·n elements.
  As many blocks as fit on each SM (one at 112 rows, three at 40) stream
  their 32-column chunks of ``S`` through shared memory (cp.async, six
  stages); in f64 ``uᵀ`` stays in registers as the A fragments of FP64
  tensor-core products (DMMA), in f32 FMAs.  A column belongs to one
  block, so nothing is reduced across blocks.
* ``lsmr_update`` replaces ``lsmr_update_pallas`` (cg_fused.py:336): one
  LSMR iteration's ``h̄' = h − c0·h̄``, ``x' = x + c1·h̄'``, ``h' = v − c2·h``.
  Bytes-bound, 7n elements for 6n flops: one grid-stride pass (16-byte
  loads where aligned, the grid from the occupancy API) reads ``x, h̄, h,
  v`` once and writes the three outputs once.  Its second arm,
  ``lsmr_step``, is everything of the LSMR iteration after its last
  reduction: α⁺ = ‖w‖, both Givens rotations, c0–c2, ``v⁺ = w / α⁺``, the
  exact-termination latch, the status, the trace slot, j and the next
  active flag, every output masked by the step's active flag.

The step arms of K1, K6, K2 and K7 take ``(B, n)`` vectors too: B
independent steps (a batch of tenants) in one launch, each lane bit for
bit the one-lane arm on its data.  The step
arms carry their scalars on the card: the loop never waits on
the host, and each scalar is rounded as the eager op it replaces (their
plain versions, ``*_step_plain``, are the loops' former eager lines in
their order), so the card's scalars are bit for bit the plain versions'.
All reductions are deterministic (no float atomics) and accumulate in the
working dtype: f64 kernels in f64, f32 kernels in f32.  Ragged tails are
masked in the kernels, not padded.

Beside each kernel wrapper (``*_cuda``) sits its plain PyTorch version
(``*_plain``): the CPU path and the card's yardstick.  It is the oracle of
:mod:`repro_torch.kernels.ref` plus the counter below, and writes the
recording buffers in place as the kernel does.  The wrapper launches
only on CUDA tensors and raises on anything it does not take; dispatch by
device lives in :mod:`repro_torch.kernels.ops`.  The counters
``LAUNCHES`` and ``PLAIN_ON_CUDA`` are those of
:mod:`repro_torch.kernels._runtime`, shared with ``rbf_matvec``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _runtime, ref

LAUNCHES = _runtime.LAUNCHES
PLAIN_ON_CUDA = _runtime.PLAIN_ON_CUDA

THREADS = 256
MAX_K = 16
MAX_GRAM_ROWS = 128
GRAM_COLS = 32  # columns of S a shared-memory stage of self_gram holds
GRAM_GRID = 132  # self_gram's partial pass: one block per SM
REC_COLS = 32  # columns of S a shared-memory stage of recombine_blocks holds
MAX_BLOCKS_PER_SM = 2048 // THREADS  # the most 256-thread blocks an SM holds
# The carried LSMR scalars, in the order of the kernel's packed state.
LSMR_SLOTS = ("alpha", "zetabar", "alphabar", "rho", "rhobar", "cbar", "sbar")
# engine.SolveStatus's codes that the step tails write.
BREAKDOWN_NONFINITE, BREAKDOWN_INDEFINITE, STAGNATED = 2, 3, 4
# The stall detector's bar: the best residual must fall below this share of
# itself within the window (1 %), or the solve is STAGNATED.
STAGNATION_RTOL = 0.99

_P, _I, _L = _runtime.PTR, _runtime.INT, _runtime.INT64
_SIGNATURES = {
    "fused_cg_update": (_P, _P, _P, _P, _P, _P, _I, _L, _P, _P, _P, _I, _P, _P, _P),
    "fused_cg_step": (_P, _P, _P, _P, _P, _I, _L, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P,
                      _P, _P, _L, _I, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _I, _P),
    "fused_rz_reduce": (_P, _P, _P, _I, _L, _P, _I, _P, _P),
    "fused_rz_pair": (_P, _P, _P, _I, _L, _P, _I, _P, _P),
    "fused_rz_step": (_P, _P, _P, _I, _L, _P, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P, _I,
                      _P),
    "fused_deflate_direction": (_P, _P, _P, _P, _P, _I, _L, _P, _P, _P, _P, _P),
    "fused_direction_step": (_P, _P, _P, _P, _P, _I, _L, _P, _P, _P, _P, _I, _I, _P, _P, _I,
                             _P),
    "self_gram": (_P, _I, _L, _L, _I, _P, _P),
    "recombine_blocks": (_P, _P, _I, _I, _L, _P, _I),
    "lsmr_update": (_P, _P, _P, _P, _P, _P, _P, _L, _P, _P, _P),
    "lsmr_step": (_P, _P, _P, _P, _P, _L, _P, _P, _P, _P, _P, _P, _P, _L, _I, _P, _P, _P, _P,
                  _P, _P, _P, _P),
    "lsmr_step_lanes": (_P, _P, _P, _P, _P, _L, _P, _P, _P, _P, _P, _P, _P, _L, _I, _P, _P, _P,
                        _P, _P, _P, _P, _P, _I, _P),
}
_cdiv = _runtime.cdiv
_ptr = _runtime.ptr
_check = _runtime.check
_scalar = _runtime.scalar
_note_plain = _runtime.note_plain


def _launch(name: str, like: torch.Tensor, *args, key: Optional[str] = None,
            arm: Optional[str] = None) -> None:
    _runtime.launch("cg_fused", name, _SIGNATURES[name], like, *args, key=key, arm=arm)


def _check_flags(name: str, like: torch.Tensor, js=None, window: int = 0, **flags) -> None:
    """The integer and boolean scalars of a step: ``js = [j, fail]``
    (int32, (2,); ``[j, fail, stall]``, (3,), with the stall detector
    armed, ``window > 0``) and each named flag (bool, 0-d), on ``like``'s
    device."""
    wanted = [(key, t, torch.bool, ()) for key, t in flags.items()]
    if js is not None:
        wanted.insert(0, ("js", js, torch.int32, (3 if window > 0 else 2,)))
    for key, t, dtype, shape in wanted:
        if t.device != like.device or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: {key} must be a {dtype} tensor of shape {shape} on "
                             f"{like.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")


@functools.lru_cache(maxsize=None)
def _reduce_scratch(device: torch.device, dtype: torch.dtype, lanes: int):
    """``(partials, counter, rows)`` of the one-launch reductions of
    ``fused_cg_update`` and ``fused_rz_reduce`` on ``device``: room for the
    most blocks the card holds at once, each with the 2(k + 1) columns of
    K6's pair arm, allocated once per device, dtype and lane count and
    shared by every call (the last block resets the counter, so calls must
    follow one another on one stream).  The step arms' lane axis widens it
    by ``lanes``: lane i's partials are rows ``[i·rows, (i + 1)·rows)``, its
    counter ``counter[i]``."""
    rows = torch.cuda.get_device_properties(device).multi_processor_count * MAX_BLOCKS_PER_SM
    partials = torch.empty((lanes * rows, 2 * (MAX_K + 1)), dtype=dtype, device=device)
    counter = torch.zeros((lanes,) if lanes > 1 else (), dtype=torch.int32, device=device)
    return partials, counter, rows


def _lead(v: torch.Tensor):
    """``(lead, n)`` of a step arm's vector: ``lead`` is ``()`` for one lane
    and ``(B,)`` on the lane axis."""
    if v.ndim not in (1, 2):
        raise ValueError(f"a step arm takes (n,) or (B, n) vectors, got {tuple(v.shape)}")
    return tuple(v.shape[:-1]), v.shape[-1]


def _arm(name: str, lead) -> str:
    """The entry point's name in :data:`_runtime.ARMS`: ``_lanes`` appended
    on the lane axis."""
    return f"{name}_lanes" if lead else name


def _step_scalars(name: str, like: torch.Tensor, lead, scalars):
    """Check a step arm's scalars; return the entry point's last two
    arguments, ``(lanes, strides)``.

    ``scalars`` is a list of ``(key, tensor, dtype, trailing shape)``, each
    tensor of shape ``lead + trailing`` on ``like``'s device (None: an
    absent input).  One lane (``lead`` empty): each contiguous, and the
    arguments are ``(1, None)``.  The lane axis (``lead = (B,)``): any lane
    stride (views of packed step outputs, e.g. ``so[:, 0]``), trailing dims
    contiguous, and the lane strides go to the kernel as a pointer to an
    ``int64`` host array (which the pointer object keeps alive; an absent
    input's stride is 0)."""
    strides = []
    for key, t, dtype, trail in scalars:
        if t is None:
            strides.append(0)
            continue
        shape = tuple(lead) + tuple(trail)
        if t.device != like.device or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: {key} must be a {dtype} tensor of shape {shape} on "
                             f"{like.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
        if not lead and not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
        if lead and trail and t.stride(-1) != 1:
            raise ValueError(f"{name}: {key} must be contiguous along its last dim")
        strides.append(t.stride(0) if lead else 0)
    if not lead:
        return 1, None
    return lead[0], ctypes.cast((ctypes.c_int64 * len(strides))(*strides), ctypes.c_void_p)


def _per_lane(plain, lanes: int, *args, **kwargs):
    """A plain step version over a lane axis: the one-lane plain version on
    each lane's slices (every tensor argument with a leading lane axis,
    in-place buffers written through views), outputs stacked."""
    def at(v, i):
        return v[i] if isinstance(v, torch.Tensor) and v.ndim > 0 else v

    outs = [plain(*(at(a, i) for a in args), **{k: at(v, i) for k, v in kwargs.items()})
            for i in range(lanes)]
    if isinstance(outs[0], torch.Tensor):
        return torch.stack(outs)
    return tuple(torch.stack([o[q] for o in outs]) for q in range(len(outs[0])))


def classify_breakdown(d, rnorm, diverged_at):
    """``(bad, code)`` from the ``pᵀAp`` reduction: non-finite, indefinite,
    or a residual past the divergence ceiling (classed STAGNATED)."""
    nonfinite = ~torch.isfinite(d)
    indefinite = (~nonfinite) & (d <= 0.0)
    diverging = rnorm > diverged_at
    bad = nonfinite | indefinite | diverging
    code = torch.where(
        nonfinite, BREAKDOWN_NONFINITE, torch.where(indefinite, BREAKDOWN_INDEFINITE, STAGNATED)
    )
    return bad, torch.where(bad, code, 0).to(torch.int32)


def stagnation_update(best, stall, norm_new, fail, active, window: int):
    """One step of the stall detector: ``(best', stall', fail')``.

    ``best`` is the best residual so far, ``stall`` (int32) the active
    iterations since it last fell below ``STAGNATION_RTOL·best``; STAGNATED
    is latched into the sticky ``fail`` once ``stall`` reaches ``window``.
    Frozen steps (``active`` false) change nothing."""
    improved = norm_new < STAGNATION_RTOL * best
    stall_new = torch.where(improved, 0, stall + 1).to(torch.int32)
    fail = torch.where(
        (fail == 0) & active & (stall_new >= window), STAGNATED, fail
    ).to(torch.int32)
    return (torch.where(active, torch.minimum(best, norm_new), best),
            torch.where(active, stall_new, stall), fail)


def trace_write(trace, j, value, active):
    """Slot ``j + 1`` of a residual trace, kept on frozen steps."""
    slot = (j + 1).reshape(1).to(torch.int64)
    old = trace.index_select(0, slot)
    trace.index_copy_(0, slot, torch.where(active, value.reshape(1), old))


def still_active(j, norm, fail, threshold, maxiter):
    """The masked-step harness's test: another live step follows."""
    return (j < maxiter) & (norm > threshold) & (fail == 0)


def safe(v):
    """``v`` with zeros replaced by 1: the solver loops' guarded divisor."""
    return torch.where(v == 0.0, 1.0, v)


def sym_ortho(a, b):
    """Stable Givens pair ``(c, s, r)`` with ``r = √(a² + b²)``; ``r = 0``
    (exact termination, latched as converged) gives ``(0, 0, 0)``."""
    r = torch.sqrt(a * a + b * b)
    safe_r = safe(r)
    return a / safe_r, b / safe_r, r


def _gram_grid(n: int):
    """``(blocks, columns per block)`` of the self-gram partial pass."""
    blocks = min(_cdiv(n, GRAM_COLS), GRAM_GRID)
    cols = _cdiv(_cdiv(n, blocks), GRAM_COLS) * GRAM_COLS
    return _cdiv(n, cols), cols


# ---------------------------------------------------------------------------
# fused_cg_update
# ---------------------------------------------------------------------------


def fused_cg_update_cuda(x, r, p, ap, alpha, aw=None):
    """``(x + α p, r − α ap, ‖r_new‖², AW @ r_new | None)`` on the card.

    ``alpha`` is a 0-d tensor on the device (a Python number is copied
    there).  ``rr`` and ``awr`` stay on the device.
    """
    n = x.shape[0]
    k = 0 if aw is None else aw.shape[0]
    alpha = _scalar(alpha, x)
    shapes = {"x": (x, (n,)), "r": (r, (n,)), "p": (p, (n,)), "ap": (ap, (n,)),
              "alpha": (alpha, ())}
    if aw is not None:
        shapes["aw"] = (aw, (k, n))
    _check("fused_cg_update", x, **shapes)
    if n == 0 or k > MAX_K:
        raise ValueError(f"fused_cg_update: need n >= 1 and k <= {MAX_K}, got n={n}, k={k}")
    partials, counter, rows = _reduce_scratch(x.device, x.dtype, 1)
    xo = torch.empty_like(x)
    ro = torch.empty_like(r)
    rr = torch.empty((), dtype=x.dtype, device=x.device)
    awr = torch.empty((k,), dtype=x.dtype, device=x.device) if k else None
    _launch("fused_cg_update", x,
            _ptr(x), _ptr(r), _ptr(p), _ptr(ap), _ptr(alpha), _ptr(aw), k, n,
            _ptr(xo), _ptr(ro), _ptr(partials), rows, _ptr(counter), _ptr(rr), _ptr(awr))
    return xo, ro, rr, awr


def fused_cg_update_plain(x, r, p, ap, alpha, aw=None):
    """Plain PyTorch version of :func:`fused_cg_update_cuda`."""
    _note_plain("fused_cg_update", x)
    return ref.fused_cg_update(x, r, p, ap, alpha, aw)


def fused_cg_step_cuda(x, r, p, ap, d, rs, rnorm, js, active, threshold, diverged_at, maxiter,
                       aw=None, waw_inv=None, *, recurrence=True, trace=None, row=None,
                       a_rows=None, b_rows=None, window=0, best=None):
    """One def-CG iteration from ``d = pᵀAp`` to the next direction's
    scalars, in ONE launch of ``fused_cg_update``'s kernel.

    In: the iterates ``x, r, p``, the product ``ap``, the device scalars
    ``d``, ``rs`` (the carried ``rᵀz``), ``rnorm``, ``threshold``,
    ``diverged_at``, ``js = [j, fail]`` (int32) and ``active`` (bool),
    the deflation products ``aw`` (k, n) with ``waw_inv = (WᵀAW)⁻¹``.
    ``recurrence`` (no preconditioner: ``rᵀr`` is the recurrence scalar)
    forms ``β`` and ``μ`` and, on a recording step (``row`` given), writes
    ``α, β`` into row ``active ? row : ell`` of ``a_rows, b_rows``
    (``(ell + 1,)``, in place); ``trace`` takes slot ``j + 1`` in place.
    Out: ``(x', r', ap, so, js', flags)`` with ``so = [rr, rnorm', α, β,
    μ…]`` (β = 0 without ``recurrence``), ``flags = [active', keep]``
    (``keep = active ∧ ¬bad``, the ``p`` select's mask).  A poisoned ``ap``
    is zeroed in place (a copy first where it aliases ``x``, ``r`` or
    ``p``), and returned.

    ``window > 0`` arms the stall detector (:func:`stagnation_update` on
    the fresh ``√rr``): ``js = [j, fail, stall]`` and the best residual
    ``best`` (0-d) come in, ``js'`` carries the new stall count and
    ``so`` one more slot, ``best'``, at its end.  Window 0 is the unarmed
    arm, bit for bit.

    The lane axis: ``(B, n)`` vectors run B independent steps in ONE
    launch (``gridDim.y = B``), each lane with its own scalars, flags,
    trace, recording slot, partials and ticket counter: ``aw`` (B, k, n),
    ``waw_inv`` (B, k, k), ``trace`` (B, maxiter + 2), ``a_rows``/
    ``b_rows`` (B, ell + 1), the per-lane scalars ``(B,)`` and ``js``
    ``(B, 2|3)`` of any lane stride (views of the previous step's packed
    outputs), and the outputs gain the leading B.  Each lane takes the
    loads and the grid a one-lane launch on its data takes and sums in its
    order: lane i is bit for bit a one-lane launch on lane i's data.
    """
    lead, n = _lead(x)
    k = 0 if aw is None else aw.shape[-2]
    armed = window > 0
    shapes = {"x": (x, lead + (n,)), "r": (r, lead + (n,)), "p": (p, lead + (n,)),
              "ap": (ap, lead + (n,))}
    if aw is not None:
        shapes.update(aw=(aw, lead + (k, n)), waw_inv=(waw_inv, lead + (k, k)))
    if trace is not None:
        shapes["trace"] = (trace, lead + (maxiter + 2,))
    recording = recurrence and row is not None
    if recording:
        ell = a_rows.shape[-1] - 1
        shapes.update(a_rows=(a_rows, lead + (ell + 1,)), b_rows=(b_rows, lead + (ell + 1,)))
    _check("fused_cg_update", x, **shapes)
    lanes, strides = _step_scalars(
        "fused_cg_update", x, lead,
        [(key, t, x.dtype, ()) for key, t in (("d", d), ("rs", rs), ("rnorm", rnorm),
                                             ("threshold", threshold),
                                             ("diverged_at", diverged_at))]
        + [("js", js, torch.int32, (2 + armed,)), ("active", active, torch.bool, ()),
           ("best", best if armed else None, x.dtype, ())])
    if n == 0 or k > MAX_K or (aw is not None and not recurrence):
        raise ValueError(f"fused_cg_step: need n >= 1, k <= {MAX_K} and the deflation GEMV "
                         f"only with the recurrence; got n={n}, k={k}")
    if ap.data_ptr() in (x.data_ptr(), r.data_ptr(), p.data_ptr()):
        ap = ap.clone()
    partials, counter, rows = _reduce_scratch(x.device, x.dtype, lanes)
    xo = torch.empty_like(x)
    ro = torch.empty_like(r)
    so = torch.empty(lead + (4 + k + armed,), dtype=x.dtype, device=x.device)
    jo = torch.empty(lead + (2 + armed,), dtype=torch.int32, device=x.device)
    bo = torch.empty(lead + (2,), dtype=torch.bool, device=x.device)
    _launch("fused_cg_step", x,
            _ptr(x), _ptr(r), _ptr(p), _ptr(ap), _ptr(aw), k, n, _ptr(xo), _ptr(ro),
            _ptr(partials), rows, _ptr(counter), _ptr(d), _ptr(rs), _ptr(rnorm),
            _ptr(threshold), _ptr(diverged_at), _ptr(js), _ptr(active), _ptr(waw_inv),
            maxiter, int(recurrence), _ptr(trace), _ptr(a_rows if recording else None),
            _ptr(b_rows if recording else None), row if recording else -1,
            ell if recording else 0, window if armed else 0, _ptr(best if armed else None),
            _ptr(so), _ptr(jo), _ptr(bo), lanes, strides, key="fused_cg_update",
            arm=_arm("fused_cg_step", lead))
    return xo, ro, ap, so, jo, bo


def fused_cg_step_plain(x, r, p, ap, d, rs, rnorm, js, active, threshold, diverged_at, maxiter,
                        aw=None, waw_inv=None, *, recurrence=True, trace=None, row=None,
                        a_rows=None, b_rows=None, window=0, best=None):
    """Plain PyTorch version of :func:`fused_cg_step_cuda`: def-CG's
    former eager lines around the update, in their order (on the lane
    axis, lane by lane)."""
    if x.ndim == 2:
        return _per_lane(fused_cg_step_plain, x.shape[0], x, r, p, ap, d, rs, rnorm, js, active,
                         threshold, diverged_at, maxiter, aw, waw_inv, recurrence=recurrence,
                         trace=trace, row=row, a_rows=a_rows, b_rows=b_rows, window=window,
                         best=best)
    _note_plain("fused_cg_update", x)
    j, fail = js[0], js[1]
    bad, code = classify_breakdown(d, rnorm, diverged_at)
    fail = torch.where((fail == 0) & active, code, fail)
    # Sanitize a poisoned A·p before the update touches it.
    ap = torch.where(bad, 0.0, ap)
    alpha = torch.where(bad | ~active, 0.0, rs / torch.where(bad, 1.0, d))
    x, r, rr, awr = ref.fused_cg_update(x, r, p, ap, alpha, aw)
    beta, mu = torch.zeros_like(rr), rr.new_zeros((0,))
    if recurrence:
        if aw is not None:
            mu = waw_inv @ awr
        beta = rr / torch.where(rs == 0.0, 1.0, rs)
        if row is not None:
            slot = torch.where(active, row, a_rows.shape[0] - 1).to(torch.int64).reshape(1)
            a_rows.index_copy_(0, slot, alpha.reshape(1))
            b_rows.index_copy_(0, slot, beta.reshape(1))
    rnorm_new = torch.sqrt(rr)
    fail = torch.where(
        (fail == 0) & active & ~torch.isfinite(rnorm_new), BREAKDOWN_NONFINITE, fail
    ).to(torch.int32)
    rnorm = torch.where(active, rnorm_new, rnorm)
    stag = []
    if window > 0:
        best, stall, fail = stagnation_update(best, js[2], rnorm_new, fail, active, window)
        stag = [stall]
    if trace is not None:
        trace_write(trace, j, rnorm, active)
    j = j + active.to(j.dtype)
    so = torch.cat([torch.stack([rr, rnorm, alpha, beta]), mu]
                   + ([best.reshape(1)] if window > 0 else []))
    flags = torch.stack([still_active(j, rnorm, fail, threshold, maxiter), active & ~bad])
    return x, r, ap, so, torch.stack([j, fail] + stag), flags


# ---------------------------------------------------------------------------
# fused_rz_reduce
# ---------------------------------------------------------------------------


def _rz_checks(name, r, z, aw, **more):
    n = r.shape[0]
    k = 0 if aw is None else aw.shape[0]
    shapes = {"r": (r, (n,)), "z": (z, (n,)), **more}
    if aw is not None:
        shapes["aw"] = (aw, (k, n))
    _check("fused_rz_reduce", r, **shapes)
    if n == 0 or k > MAX_K:
        raise ValueError(f"{name}: need n >= 1 and k <= {MAX_K}, got n={n}, k={k}")
    return n, k


def fused_rz_reduce_cuda(r, z, aw=None):
    """``(rᵀz, AW @ z | None)`` on the card, both on the device: ONE launch
    (the last block to draw a ticket sums the partials in block order)."""
    n, k = _rz_checks("fused_rz_reduce", r, z, aw)
    partials, counter, rows = _reduce_scratch(r.device, r.dtype, 1)
    out = torch.empty((1 + k,), dtype=r.dtype, device=r.device)
    _launch("fused_rz_reduce", r,
            _ptr(r), _ptr(z), _ptr(aw), k, n, _ptr(partials), rows, _ptr(counter), _ptr(out))
    return out[0], (out[1:] if k else None)


def fused_rz_reduce_plain(r, z, aw=None):
    """Plain PyTorch version of :func:`fused_rz_reduce_cuda`."""
    _note_plain("fused_rz_reduce", r)
    return ref.fused_rz_reduce(r, z, aw)


def fused_rz_step_cuda(r, z, rs, aw=None, waw_inv=None, *, alpha=None, active=None, row=None,
                       a_rows=None, b_rows=None):
    """The preconditioned def-CG and cg tail after ``z = M⁻¹r``, in ONE
    launch of ``fused_rz_reduce``'s kernel.

    In: ``r``, ``z``, the carried ``rs`` (the previous ``rᵀz``, 0-d), the
    deflation products ``aw`` (k, n) with ``waw_inv = (WᵀAW)⁻¹`` (row-major).
    On a recording step (``row`` given) ``alpha`` (0-d, K1's α) and ``β`` go
    to row ``active ? row : ell`` of ``a_rows, b_rows`` (``(ell + 1,)``, in
    place).  Out: ``so = [rs', β, μ…]`` with ``rs' = rᵀz``, ``β = rs' /
    safe(rs)``, ``μ = waw_inv·(AW)ᵀz`` (fresh; K2's step arm reads β and μ
    from it).  ``(B, n)`` vectors run the lane axis, as
    :func:`fused_cg_step_cuda`'s: ``rs``, ``alpha`` and ``active`` are
    ``(B,)`` of any lane stride, ``so`` is ``(B, 2 + k)``.
    """
    if row is None:
        alpha = active = a_rows = b_rows = None
    lead, n = _lead(r)
    k = 0 if aw is None else aw.shape[-2]
    ell = -1 if row is None else a_rows.shape[-1] - 1
    shapes = {"r": (r, lead + (n,)), "z": (z, lead + (n,))}
    if aw is not None:
        shapes.update(aw=(aw, lead + (k, n)), waw_inv=(waw_inv, lead + (k, k)))
    if row is not None:
        shapes.update(a_rows=(a_rows, lead + (ell + 1,)), b_rows=(b_rows, lead + (ell + 1,)))
    _check("fused_rz_reduce", r, **shapes)
    if n == 0 or k > MAX_K:
        raise ValueError(f"fused_rz_step: need n >= 1 and k <= {MAX_K}, got n={n}, k={k}")
    lanes, strides = _step_scalars("fused_rz_reduce", r, lead,
                                   [("rs", rs, r.dtype, ()), ("alpha", alpha, r.dtype, ()),
                                    ("active", active, torch.bool, ())])
    partials, counter, rows = _reduce_scratch(r.device, r.dtype, lanes)
    so = torch.empty(lead + (2 + k,), dtype=r.dtype, device=r.device)
    _launch("fused_rz_step", r,
            _ptr(r), _ptr(z), _ptr(aw), k, n, _ptr(partials), rows, _ptr(counter), _ptr(rs),
            _ptr(alpha), _ptr(active), _ptr(waw_inv), _ptr(a_rows), _ptr(b_rows),
            -1 if row is None else row, ell, _ptr(so), lanes, strides,
            key="fused_rz_reduce", arm=_arm("fused_rz_step", lead))
    return so


def fused_rz_step_plain(r, z, rs, aw=None, waw_inv=None, *, alpha=None, active=None, row=None,
                        a_rows=None, b_rows=None):
    """Plain PyTorch version of :func:`fused_rz_step_cuda`: the
    preconditioned loops' former eager lines after ``z = M⁻¹r``, in their
    order (on the lane axis, lane by lane)."""
    if r.ndim == 2:
        return _per_lane(fused_rz_step_plain, r.shape[0], r, z, rs, aw, waw_inv, alpha=alpha,
                         active=active, row=row, a_rows=a_rows, b_rows=b_rows)
    _note_plain("fused_rz_reduce", r)
    rs_new, awz = ref.fused_rz_reduce(r, z, aw)
    mu = waw_inv @ awz if aw is not None else rs_new.new_zeros((0,))
    beta = rs_new / torch.where(rs == 0.0, 1.0, rs)
    if row is not None:
        slot = torch.where(active, row, a_rows.shape[0] - 1).to(torch.int64).reshape(1)
        a_rows.index_copy_(0, slot, alpha.reshape(1))
        b_rows.index_copy_(0, slot, beta.reshape(1))
    return torch.cat([torch.stack([rs_new, beta]), mu])


def fused_rz_pair_cuda(r, ap, aw=None):
    """``(rᵀap, AW @ ap, rᵀr, AW @ r)`` on the card in ONE launch (one read
    of ``r``, ``ap`` and ``aw``): the sharded def-CG's fresh reductions.
    Each is summed in the order of :func:`fused_rz_reduce_cuda` on the same
    inputs, so the four are two one-vector calls' bit for bit.  Views of
    one device buffer (the ``AW`` products None when ``aw`` is None)."""
    n, k = _rz_checks("fused_rz_pair", r, ap, aw)
    partials, counter, rows = _reduce_scratch(r.device, r.dtype, 1)
    out = torch.empty((2 * (1 + k),), dtype=r.dtype, device=r.device)
    _launch("fused_rz_pair", r,
            _ptr(r), _ptr(ap), _ptr(aw), k, n, _ptr(partials), rows, _ptr(counter), _ptr(out),
            key="fused_rz_reduce")
    return out[0], (out[1:1 + k] if k else None), out[1 + k], (out[2 + k:] if k else None)


def fused_rz_pair_plain(r, ap, aw=None):
    """Plain PyTorch version of :func:`fused_rz_pair_cuda`: the two
    one-vector reductions it replaces."""
    _note_plain("fused_rz_reduce", r)
    rap, awap = ref.fused_rz_reduce(r, ap, aw)
    rr, awr = ref.fused_rz_reduce(r, r, aw)
    return rap, awap, rr, awr


# ---------------------------------------------------------------------------
# fused_deflate_direction
# ---------------------------------------------------------------------------


def _dir_checks(name, z, p, beta, w, mu, ap=None, p_buf=None, ap_buf=None):
    n = z.shape[0]
    k = 0 if w is None else w.shape[0]
    shapes = {"z": (z, (n,)), "p": (p, (n,)), "beta": (beta, ())}
    if w is not None:
        shapes.update(w=(w, (k, n)), mu=(mu, (k,)))
    if p_buf is not None:
        rows = p_buf.shape[0]
        shapes.update(ap=(ap, (n,)), p_buf=(p_buf, (rows, n)), ap_buf=(ap_buf, (rows, n)))
    _check("fused_deflate_direction", z, **shapes)
    if n == 0 or k > MAX_K:
        raise ValueError(f"{name}: need n >= 1 and k <= {MAX_K}, got n={n}, k={k}")
    return n, k


def fused_deflate_direction_cuda(
    r, p, beta, w=None, mu=None, ap=None, idx=None, p_buf=None, ap_buf=None
):
    """``p_new = β p + r − μᵀ W`` on the card, optionally recording.

    With ``p_buf``/``ap_buf`` the incoming ``p`` and ``ap`` are written into
    row ``idx`` (a 0-d int64 device tensor; a Python int is copied there)
    of both buffers IN PLACE.  Returns ``(p_new, p_buf, ap_buf)``.
    ``w=None`` is the plain-CG direction update (k = 0).
    """
    beta = _scalar(beta, r)
    record = p_buf is not None
    if record:
        idx = torch.as_tensor(idx, dtype=torch.int64, device=r.device).reshape(())
    n, k = _dir_checks("fused_deflate_direction", r, p, beta, w, mu, ap, p_buf, ap_buf)
    po = torch.empty_like(p)
    _launch("fused_deflate_direction", r,
            _ptr(r), _ptr(p), _ptr(beta), _ptr(w), _ptr(mu), k, n, _ptr(po),
            _ptr(ap if record else None), _ptr(idx if record else None),
            _ptr(p_buf), _ptr(ap_buf))
    return po, p_buf, ap_buf


def fused_deflate_direction_plain(
    r, p, beta, w=None, mu=None, ap=None, idx=None, p_buf=None, ap_buf=None
):
    """Plain PyTorch version of :func:`fused_deflate_direction_cuda`
    (buffers written in place, like the kernel)."""
    _note_plain("fused_deflate_direction", r)
    p_new, _, _ = ref.fused_deflate_direction(r, p, beta, w, mu)
    if p_buf is not None:
        row = torch.as_tensor(idx, dtype=torch.int64, device=r.device).reshape(1)
        p_buf.index_copy_(0, row, p[None])
        ap_buf.index_copy_(0, row, ap[None])
    return p_new, p_buf, ap_buf


def fused_direction_step_cuda(z, p, beta, keep, w=None, mu=None, *, ap=None, active=None,
                              row=None, p_buf=None, ap_buf=None):
    """The solver loops' direction update with the ``p`` select, in ONE
    launch of ``fused_deflate_direction``'s kernel: a fresh
    ``keep ? β p + z − μᵀW : p``.

    ``beta`` (0-d), ``mu`` (k,) and ``keep`` (bool, 0-d) stay on the device:
    views of K1's or K6's packed step outputs (``so[3], so[4:]`` /
    ``so[1], so[2:]``, K1's ``flags[1]``) or the sharded loops' own.  On a
    recording step (``row`` given) the incoming ``p`` and ``ap`` go to row
    ``active ? row : ell`` of the ``(ell + 1, n)`` buffers, in place.
    ``(B, n)`` vectors run the lane axis: ``w`` (B, k, n), the buffers
    (B, ell + 1, n), ``beta``, ``keep``, ``active`` ``(B,)`` and ``mu``
    ``(B, k)`` of any lane stride.
    """
    if row is None:
        ap = active = p_buf = ap_buf = None
    lead, n = _lead(z)
    k = 0 if w is None else w.shape[-2]
    ell = -1 if row is None else p_buf.shape[-2] - 1
    shapes = {"z": (z, lead + (n,)), "p": (p, lead + (n,))}
    if w is not None:
        shapes["w"] = (w, lead + (k, n))
    if p_buf is not None:
        shapes.update(ap=(ap, lead + (n,)), p_buf=(p_buf, lead + (ell + 1, n)),
                      ap_buf=(ap_buf, lead + (ell + 1, n)))
    _check("fused_deflate_direction", z, **shapes)
    if n == 0 or k > MAX_K:
        raise ValueError(f"fused_direction_step: need n >= 1 and k <= {MAX_K}, got n={n}, k={k}")
    lanes, strides = _step_scalars("fused_deflate_direction", z, lead,
                                   [("beta", beta, z.dtype, ()),
                                    ("mu", mu if w is not None else None, z.dtype, (k,)),
                                    ("keep", keep, torch.bool, ()),
                                    ("active", active, torch.bool, ())])
    po = torch.empty_like(p)
    _launch("fused_direction_step", z,
            _ptr(z), _ptr(p), _ptr(beta), _ptr(w), _ptr(mu), k, n, _ptr(po), _ptr(keep),
            _ptr(ap), _ptr(active), -1 if row is None else row, ell, _ptr(p_buf), _ptr(ap_buf),
            lanes, strides, key="fused_deflate_direction", arm=_arm("fused_direction_step", lead))
    return po


def fused_direction_step_plain(z, p, beta, keep, w=None, mu=None, *, ap=None, active=None,
                               row=None, p_buf=None, ap_buf=None):
    """Plain PyTorch version of :func:`fused_direction_step_cuda`: the
    loops' former eager lines (the recording slot, the direction update,
    the ``p`` select), in their order (on the lane axis, lane by lane)."""
    if z.ndim == 2:
        return _per_lane(fused_direction_step_plain, z.shape[0], z, p, beta, keep, w, mu, ap=ap,
                         active=active, row=row, p_buf=p_buf, ap_buf=ap_buf)
    _note_plain("fused_deflate_direction", z)
    if row is not None:
        slot = torch.where(active, row, p_buf.shape[0] - 1).to(torch.int64).reshape(1)
        p_buf.index_copy_(0, slot, p[None])
        ap_buf.index_copy_(0, slot, ap[None])
    p_new, _, _ = ref.fused_deflate_direction(z, p, beta, w, mu)
    return torch.where(keep, p_new, p)


# ---------------------------------------------------------------------------
# self_gram
# ---------------------------------------------------------------------------


def self_gram_cuda(s: torch.Tensor) -> torch.Tensor:
    """``S Sᵀ`` for ``S`` of shape ``(m2, n)``, m2 ≤ 128, on the card."""
    m2, n = s.shape
    _check("self_gram", s, s=(s, (m2, n)))
    if n == 0 or not 1 <= m2 <= MAX_GRAM_ROWS:
        raise ValueError(f"self_gram: need n >= 1 and 1 <= rows <= {MAX_GRAM_ROWS}, got {m2}")
    blocks, cols = _gram_grid(n)
    r8 = _cdiv(m2, 8)  # 8 x 8 tiles of the upper triangle, 64 values each
    partials = torch.empty((blocks, r8 * (r8 + 1) // 2 * 64), dtype=s.dtype, device=s.device)
    out = torch.empty((m2, m2), dtype=s.dtype, device=s.device)
    _launch("self_gram", s,
            _ptr(s), m2, n, cols, blocks, _ptr(partials), _ptr(out))
    return out


def self_gram_plain(s: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`self_gram_cuda`."""
    _note_plain("self_gram", s)
    return ref.self_gram(s)


# ---------------------------------------------------------------------------
# recombine_blocks
# ---------------------------------------------------------------------------


def recombine_blocks_cuda(s: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """``[uᵀ S_top; uᵀ S_bot]`` for ``S`` (2m, n), ``u`` (m, k), on the card."""
    m2, n = s.shape
    m, k = u.shape
    u = u.to(s.dtype).contiguous()
    _check("recombine_blocks", s, s=(s, (2 * m, n)), u=(u, (m, k)))
    if n == 0 or 2 * m > MAX_GRAM_ROWS or not 1 <= k <= MAX_K:
        raise ValueError(
            f"recombine_blocks: need n >= 1, 2m <= {MAX_GRAM_ROWS}, 1 <= k <= {MAX_K}; "
            f"got n={n}, m={m}, k={k}"
        )
    out = torch.empty((2 * k, n), dtype=s.dtype, device=s.device)
    _launch("recombine_blocks", s,
            _ptr(s), _ptr(u), m, k, n, _ptr(out), _cdiv(n, REC_COLS))
    return out


def recombine_blocks_plain(s: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`recombine_blocks_cuda`."""
    _note_plain("recombine_blocks", s)
    return ref.recombine_blocks(s, u)


# ---------------------------------------------------------------------------
# lsmr_update
# ---------------------------------------------------------------------------


def lsmr_update_cuda(x, hbar, h, v, c0, c1, c2):
    """``(x + c1·h̄', h̄' = h − c0·h̄, v − c2·h)`` on the card.

    ``c0, c1, c2`` are 0-d tensors on the device (Python numbers are
    copied there).  Returns ``(x_new, hbar_new, h_new)``.
    """
    n = x.shape[0]
    c0, c1, c2 = (_scalar(c, x) for c in (c0, c1, c2))
    _check("lsmr_update", x, x=(x, (n,)), hbar=(hbar, (n,)), h=(h, (n,)),
           v=(v, (n,)), c0=(c0, ()), c1=(c1, ()), c2=(c2, ()))
    if n == 0:
        raise ValueError("lsmr_update: need n >= 1")
    xo, hbo, ho = (torch.empty_like(x) for _ in range(3))
    _launch("lsmr_update", x,
            _ptr(x), _ptr(hbar), _ptr(h), _ptr(v), _ptr(c0), _ptr(c1), _ptr(c2), n,
            _ptr(xo), _ptr(hbo), _ptr(ho))
    return xo, hbo, ho


def lsmr_update_plain(x, hbar, h, v, c0, c1, c2):
    """Plain PyTorch version of :func:`lsmr_update_cuda`."""
    _note_plain("lsmr_update", x)
    return ref.lsmr_update(x, hbar, h, v, c0, c1, c2)


def lsmr_step_cuda(x, hbar, h, v, w, wsq, beta, s, js, active, threshold, diverged_at,
                   maxiter, trace=None, window=0):
    """One LSMR iteration after its last reduction, in ONE launch of
    ``lsmr_update``'s kernel.

    In: the iterates ``x, h̄, h, v``, ``w = g⁺ − β⁺v`` with ``wsq = ‖w‖²``
    and ``beta = β⁺`` (0-d), the carried scalars ``s`` (``LSMR_SLOTS``),
    ``js = [j, fail]`` (int32), ``active`` (bool), ``threshold`` and
    ``diverged_at``; ``trace`` takes slot ``j + 1`` in place.  Out:
    ``(x', h̄', h', v⁺, s', js', active')``, each the old value on a
    frozen step.  ``window > 0`` arms the stall detector on the fresh
    ``|ζ̄|``: ``s`` carries the best residual in one more slot after
    ``LSMR_SLOTS`` and ``js = [j, fail, stall]``.

    The lane axis: ``(B, n)`` vectors run B independent LSMR tails in ONE
    launch (``gridDim.y = B``, the ``lsmr_step_lanes`` entry): ``s``
    ``(B, 7|8)``, ``js`` ``(B, 2|3)``, the per-lane scalars ``(B,)`` and the
    trace rows ``(B, maxiter + 2)`` at any lane stride (views of the
    previous step's packed outputs), the outputs with the leading B.  Each
    lane takes the loads and the grid a one-lane launch on its data takes:
    lane i is bit for bit a one-lane launch on lane i's data.
    """
    lead, n = _lead(x)
    armed = window > 0
    if not lead:
        shapes = {"x": (x, (n,)), "hbar": (hbar, (n,)), "h": (h, (n,)), "v": (v, (n,)),
                  "w": (w, (n,)), "wsq": (wsq, ()), "beta": (beta, ()),
                  "s": (s, (len(LSMR_SLOTS) + armed,)), "threshold": (threshold, ()),
                  "diverged_at": (diverged_at, ())}
        if trace is not None:
            shapes["trace"] = (trace, (maxiter + 2,))
        _check("lsmr_update", x, **shapes)
        _check_flags("lsmr_update", x, js, window, active=active)
    else:
        _check("lsmr_update", x, x=(x, lead + (n,)), hbar=(hbar, lead + (n,)),
               h=(h, lead + (n,)), v=(v, lead + (n,)), w=(w, lead + (n,)))
        lanes, strides = _step_scalars(
            "lsmr_update", x, lead,
            [("wsq", wsq, x.dtype, ()), ("beta", beta, x.dtype, ()),
             ("s", s, x.dtype, (len(LSMR_SLOTS) + armed,)), ("js", js, torch.int32, (2 + armed,)),
             ("active", active, torch.bool, ()), ("threshold", threshold, x.dtype, ()),
             ("diverged_at", diverged_at, x.dtype, ()),
             ("trace", trace, x.dtype, (maxiter + 2,))])
    if n == 0:
        raise ValueError("lsmr_step: need n >= 1")
    xo, hbo, ho, vo = (torch.empty_like(x) for _ in range(4))
    so = torch.empty(lead + (len(LSMR_SLOTS) + armed,), dtype=x.dtype, device=x.device)
    jo = torch.empty(lead + (2 + armed,), dtype=torch.int32, device=x.device)
    ao = torch.empty(lead, dtype=torch.bool, device=x.device)
    args = (_ptr(x), _ptr(hbar), _ptr(h), _ptr(v), _ptr(w), n, _ptr(wsq), _ptr(beta), _ptr(s),
            _ptr(js), _ptr(active), _ptr(threshold), _ptr(diverged_at), maxiter,
            window if armed else 0, _ptr(trace), _ptr(xo), _ptr(hbo), _ptr(ho), _ptr(vo),
            _ptr(so), _ptr(jo), _ptr(ao))
    if lead:
        _launch("lsmr_step_lanes", x, *args, lanes, strides, key="lsmr_update")
    else:
        _launch("lsmr_step", x, *args, key="lsmr_update")
    return xo, hbo, ho, vo, so, jo, ao


def lsmr_step_plain(x, hbar, h, v, w, wsq, beta, s, js, active, threshold, diverged_at,
                    maxiter, trace=None, window=0):
    """Plain PyTorch version of :func:`lsmr_step_cuda`: the LSMR loop's
    former eager lines from α⁺ on, in their order (on the lane axis, lane
    by lane)."""
    if x.ndim == 2:
        return _per_lane(lsmr_step_plain, x.shape[0], x, hbar, h, v, w, wsq, beta, s, js,
                         active, threshold, diverged_at, maxiter, trace, window)
    _note_plain("lsmr_update", x)
    alpha, zetabar, alphabar, rho, rhobar, cbar, sbar = s[:len(LSMR_SLOTS)].unbind()
    j, fail = js[0], js[1]
    alpha_new = torch.sqrt(wsq)
    v_new = w / safe(alpha_new)

    # The two Givens rotations (Fong & Saunders 2011, §2.2; λ lives in Â
    # itself, so there is no λ-rotation).
    c, sn, rho_new = sym_ortho(alphabar, beta)
    thetanew = sn * alpha_new
    alphabar_new = c * alpha_new
    thetabar = sbar * rho_new
    cbar_new, sbar_new, rhobar_new = sym_ortho(cbar * rho_new, thetanew)
    zeta = cbar_new * zetabar
    zetabar_new = -sbar_new * zetabar

    c0 = thetabar * rho_new / (rho * rhobar)
    c1 = zeta / (safe(rho_new) * safe(rhobar_new))
    c2 = thetanew / safe(rho_new)
    x_new, hbar_new, h_new = ref.lsmr_update(x, hbar, h, v_new, c0, c1, c2)

    # Exact termination: a zero β or α drives Âᵀr̂ to zero — latch it.
    exact = (beta == 0.0) | (alpha_new == 0.0)
    zetabar_new = torch.where(exact, 0.0, zetabar_new)
    normar_new = torch.abs(zetabar_new)

    live = (fail == 0) & active
    fail = torch.where(
        live & ~torch.isfinite(normar_new), BREAKDOWN_NONFINITE, fail
    ).to(torch.int32)
    fail = torch.where(
        (fail == 0) & active & (normar_new > diverged_at), STAGNATED, fail
    ).to(torch.int32)
    stag = []
    if window > 0:
        best, stall, fail = stagnation_update(s[-1], js[2], normar_new, fail, active, window)
        stag = [best, stall]
    if trace is not None:
        trace_write(trace, j, normar_new, active)

    def sel(new, cur):
        return torch.where(active, new, cur)

    s_new = torch.stack([
        sel(alpha_new, alpha), sel(zetabar_new, zetabar), sel(alphabar_new, alphabar),
        sel(rho_new, rho), sel(rhobar_new, rhobar), sel(cbar_new, cbar), sel(sbar_new, sbar),
    ] + stag[:1])
    j = j + active.to(j.dtype)
    return (
        sel(x_new, x), sel(hbar_new, hbar), sel(h_new, h), sel(v_new, v), s_new,
        torch.stack([j, fail] + stag[1:]),
        still_active(j, torch.abs(s_new[1]), fail, threshold, maxiter),
    )
