"""The work of each traced kernel: the operations and bytes behind its bound.

Each ``*_work`` returns ``(bytes moved, operations)`` of one call at the
given shapes, every input read once and every output written once, and is
what ``chip_smoke.py`` divides by the card's peaks for a kernel's
``bound_ms`` (``PERF.md`` §6).  The same counts serve the dry-run: the
kernels that a traced step reaches (K3, K8, K9 and K10, each arm a
``torch.library`` custom op) register here, through :func:`count_op`, a
function of the op's arguments returning ``(operations, bytes, scratch
bytes)``.  ``FlopCounterMode`` reads the operations (the formula is
registered with ``register_flop_formula``), and
:mod:`repro_torch.launch.trace_stats` reads all three: the scratch is what
the wrapper allocates around the launch and frees after it (contiguous
copies, the kernels' f32 scratch), live only during the call.
"""

from __future__ import annotations

import math
from typing import Callable, Dict

import torch
from torch.utils.flop_counter import register_flop_formula

# op overload packet -> fn(*op args) -> (operations, bytes, scratch bytes)
COUNTED: Dict[object, Callable] = {}


def count_op(op, fn: Callable) -> None:
    """Register ``fn`` as ``op``'s count, and its operations as ``op``'s
    FLOPs for ``torch.utils.flop_counter``."""
    COUNTED[op] = fn
    register_flop_formula(op, get_raw=True)(
        lambda *args, out_val=None, **kwargs: fn(*args, **kwargs)[0])


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def copies(*tensors) -> int:
    """Bytes that ``.contiguous()`` copies for the tensors given."""
    return sum(nbytes(t) for t in tensors if t is not None and not t.is_contiguous())


def attn_work(b, h, hkv, sq, sk, dh, causal, itemsize):
    """(bytes, operations): q, k, v read once and o written once;
    4·b·h·sq·sk·dh flops, halved under causal masking."""
    nbytes = (2 * b * h * sq * dh + 2 * b * hkv * sk * dh) * itemsize
    ops = 4 * b * h * sq * sk * dh
    return nbytes, ops / 2 if causal else ops


def ssd_work(b, l, h, p, g, n, c, itemsize):
    """(bytes, operations): x, B, C, y in the working dtype and dt in f32,
    once each; the flops the function needs on each chunk of c' rows (the
    last one ragged): M is lower-triangular, so C Bᵀ, once per group, and
    (M ⊙ G) X take their causal half, c'(c' + 1)·n and c'(c' + 1)·p, beside
    C Hᵀ and Xᵀ·bw's 4c'·p·n per head."""
    nbytes = (2 * b * l * h * p + 2 * b * l * g * n) * itemsize + 4 * b * l * h
    rows = [min(c, l - t0) for t0 in range(0, l, c)]
    ops = sum(b * g * r * (r + 1) * n + b * h * (r * (r + 1) * p + 4 * r * p * n) for r in rows)
    return nbytes, ops


def grad_work(b, h, hkv, sq, sk, dh, causal, itemsize, arm):
    """(bytes, operations) of one call of K9's ``arm``: every input read once
    and every output written once (the f32 lse 4 bytes a row); the
    forward's flops for ``lse``, 2.5 times them (five products of its size)
    for ``bwd`` and ``jvp``."""
    q_el, kv_el, rows = b * h * sq * dh, b * hkv * sk * dh, b * h * sq
    nbytes, ops = attn_work(b, h, hkv, sq, sk, dh, causal, itemsize)
    if arm == "lse":
        return nbytes + 4 * rows, ops
    if arm == "bwd":  # q, k, v, o, dO, lse in; dq, dk, dv out
        return (3 * q_el + 2 * kv_el) * itemsize * 2 + 4 * rows, 2.5 * ops
    # jvp: q, k, v, o, q', k', v', lse in; o' out
    return (5 * q_el + 4 * kv_el) * itemsize + 4 * rows, 2.5 * ops


def ssd_grad_work(b, l, h, p, g, n, c, itemsize, arm):
    """(bytes, operations) of one call of K10's ``arm``: every input read
    once and every output written once (the f32 chunk states H and cs, dt
    and its gradient or tangent, da and the state's gradient or tangent 4
    bytes an element); the flops the function needs on each chunk of c'
    rows, causal products at their half (c'(c' + 1) per column).  bwd, per
    head: Q = dY Xᵀ and (M∘G)ᵀ dY (p wide), dGᵀ C and dG B (n wide), and
    dYᵀ C, B Γᵀ, X Γ and dY H_kᵀ (2c'·p·n each); per group G = C Bᵀ.  jvp,
    per head: Ẏ's two c' × c' products, its two state products and the
    tangent state's two (2c'·p·n each); per group G and Ġ's two
    products."""
    chunks = math.ceil(l / c)
    rows = [min(c, l - t0) for t0 in range(0, l, c)]
    xs, bc = b * l * h * p * itemsize, b * l * g * n * itemsize
    saved = 4 * (b * h * chunks * p * n + b * h * chunks * c) + 4 * b * l * h
    if arm == "bwd":  # x, B, C, dY, dt, H, cs in; dx, dB, dC, ddt, da, dh0 out
        nbytes = 2 * (xs + 2 * bc) + saved + 4 * b * l * h + 4 * h + 4 * b * h * p * n
        per_head = sum(r * (r + 1) * (2 * p + 2 * n) + 8 * r * p * n for r in rows)
        per_group = sum(r * (r + 1) * n for r in rows)
    else:  # x, B, C, their tangents, dt, ḋt, ȧ, H, cs in; ẏ, ḣ out
        nbytes = 3 * xs + 4 * bc + saved + 4 * b * l * h + 4 * h + 4 * b * h * p * n
        per_head = sum(2 * r * (r + 1) * p + 8 * r * p * n for r in rows)
        per_group = sum(3 * r * (r + 1) * n for r in rows)
    return nbytes, b * h * per_head + b * g * per_group


def rbf_work(n, d, r, itemsize):
    """(bytes moved, operations) of one RBF Gram matvec: X and V read once,
    Y written once.  K(X, X) is symmetric, so the least work forms each
    pair once: the cross term X·Xᵀ is a SYRK of n(n+1)·d flops, and the
    distances and exp (about 8 operations a pair) come to ~4n²; K·V still
    takes 2n²r, since a tile K_ij feeds both Y_i += K_ij·V_j and
    Y_j += K_ijᵀ·V_i.  The kernel forms each unordered pair of 128-row
    tiles once, so its cross term is n(n + 128)·d, within 0.4 % of this
    at the paper's n."""
    return (n * d + 2 * n * r) * itemsize, n * (n + 1) * d + 2 * n * n * r + 4 * n * n


def rect_work(m, n, d, r, itemsize):
    """(bytes moved, operations) of one K8 call: X_rows, X_cols and V read
    once, Y written once; the rectangular block has no symmetry, so every
    pair counts: 2mn·d for the cross term, 2mn·r for K·V, ~8mn for the
    distances and exp."""
    return ((m + n) * d + n * r + m * r) * itemsize, 2 * m * n * d + 2 * m * n * r + 8 * m * n
