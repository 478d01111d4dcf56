"""The one-launch reduction order of K1 and K6, emulated in torch.

``fused_cg_update`` (K1) and ``fused_rz_reduce`` (K6) share one layout
(slots of one 16-byte group or one element, two or four a thread, grid
stride) and one reduction (per-block partials, an integer ticket, the
last block's sum in block order).  :func:`emulate_sums` forms a grid's
sums the way the kernels do, for any order in which the blocks finish,
so a test can hold that order on the CPU.  Imported by the test files;
it imports no JAX.
"""

import torch

THREADS, WARPS = 256, 8


def _warp_sum(v):
    """Lane 0 of ``__shfl_down_sync``'s tree over the last axis (32 lanes):
    lanes past the end read their own value."""
    for off in (16, 8, 4, 2, 1):
        v = v + torch.cat([v[..., off:], v[..., 32 - off:]], dim=-1)
    return v[..., 0]


def emulate_sums(prods, grid, vec, order, wide=False):
    """The sums of ``prods`` (columns × n per-element products) as K1 and
    K6 form them (``csrc/cg_fused.cu``: ``CgLayout``, ``ticket_sums``).
    Each thread takes slots of ``vec`` elements (one 16-byte group; 1
    without ``vec``), two slots a step with ``vec`` and four without (half
    that for ``wide``, past k = 8 rows of AW), slot s of block b's step at
    unit ``b·256·S + s·256 + t`` (grid-stride), then the ragged tail; per
    warp the shuffle tree, per block its warps in order; blocks finish in
    ``order``, each writes its partials and draws a ticket, and the one
    that draws the last ticket sums the partials in block order (lane l
    takes blocks l, l + 32, …, then the tree)."""
    cols, n = prods.shape
    width, slots = (vec, 2) if vec else (1, 4)
    slots //= 2 if wide else 1
    units = n // width
    acc = torch.zeros(cols, grid, THREADS, dtype=prods.dtype)
    blk = torch.arange(grid)[:, None]
    thr = torch.arange(THREADS)[None, :]
    stride = grid * THREADS * slots
    zero = torch.zeros((), dtype=prods.dtype)
    for base in range(0, units, stride):
        for slot in range(slots):
            u = base + blk * THREADS * slots + slot * THREADS + thr
            ok = u < units
            for w in range(width):
                e = torch.where(ok, u * width + w, 0)
                acc += torch.where(ok, prods[:, e], zero)
    if vec:
        e = units * width + blk * THREADS + thr
        ok = e < n
        acc += torch.where(ok, prods[:, torch.where(ok, e, 0)], zero)
    warp_parts = _warp_sum(acc.reshape(cols, grid, WARPS, 32))  # (cols, grid, warps)
    partials = torch.full((grid, cols), float("nan"), dtype=prods.dtype)
    ticket, result = 0, None
    for b in order:
        s = torch.zeros(cols, dtype=prods.dtype)
        for w in range(WARPS):
            s = s + warp_parts[:, b, w]
        partials[b] = s
        if ticket == grid - 1:
            lanes = torch.zeros(cols, 32, dtype=prods.dtype)
            for b0 in range(0, grid, 32):
                chunk = partials[b0:b0 + 32].T  # (cols, ≤ 32)
                lanes[:, : chunk.shape[1]] = lanes[:, : chunk.shape[1]] + chunk
            result = _warp_sum(lanes)
        ticket += 1
    return result


# ---------------------------------------------------------------------------
# The step arms' lane axis (batched solves)
# ---------------------------------------------------------------------------


def launch_shape(n, k, itemsize, offset, resident, capacity):
    """``(vec, blocks)`` of a one-lane K1 / K6 launch on vectors starting
    ``offset`` bytes past a 16-byte boundary (``csrc/cg_fused.cu``:
    ``cg_vec`` / ``rz_vec``, ``cg_blocks`` / ``rz_blocks``): 16-byte loads
    where every vector and every row of AW is 16-byte aligned, and the
    occupancy grid of that layout."""
    rows = (n * itemsize) % 16 == 0
    vec = offset % 16 == 0 and (k == 0 or rows)
    width = 16 // itemsize if vec else 1
    slots = (2 if vec else 4) // (2 if k > 8 else 1)
    units = n // width
    threads = -(-units // slots)
    return vec, max(1, min(resident, -(-threads // THREADS), capacity))


def _rz_prods(r, z, aw):
    rows = [r * z] + ([] if aw is None else [aw[j] * z for j in range(aw.shape[0])])
    return torch.stack(rows)


def one_lane_sums(r, z, aw, offset, resident, capacity, order=None):
    """K6's sums ``[rᵀz, (AW)z]`` of a one-lane launch on ``(r, z, aw)``
    laid ``offset`` bytes past a 16-byte boundary."""
    n, k = r.shape[0], 0 if aw is None else aw.shape[0]
    vec, blocks = launch_shape(n, k, r.element_size(), offset, resident, capacity)
    order = range(blocks) if order is None else order
    return emulate_sums(_rz_prods(r, z, aw), blocks, 16 // r.element_size() if vec else 0,
                        order, wide=k > 8)


def lane_sums(r, z, aw, lane, resident, capacity):
    """Lane ``lane`` of a lane-axis launch over ``(B, n)`` stacks: the grid
    along x is as wide as the widest lane (``max`` of the two layouts'
    block counts); the lane takes the layout its own rows' alignment
    gives, and its blocks past that layout's count return before the
    ticket, so its sums span its own count.  Its blocks finish in reverse
    order here (a ticket order the one-lane run does not share)."""
    n, k = r.shape[1], 0 if aw is None else aw.shape[1]
    itemsize = r.element_size()
    offset = lane * n * itemsize
    vec, blocks = launch_shape(n, k, itemsize, offset, resident, capacity)
    wide = max(launch_shape(n, k, itemsize, o, resident, capacity)[1] for o in (0, 8))
    order = [b for b in reversed(range(wide)) if b < blocks]
    return emulate_sums(_rz_prods(r[lane], z[lane], None if aw is None else aw[lane]), blocks,
                        16 // itemsize if vec else 0, order, wide=k > 8)
