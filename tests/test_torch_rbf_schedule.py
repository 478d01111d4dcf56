"""K3's symmetric tile schedule, emulated in torch on the CPU.

The CUDA kernel (``csrc/rbf_matvec.cu``) forms each unordered pair of
128-row Gram tiles once: row tile I takes ``(I, (I + o) mod T)`` for
``o < L_I``, cut into balanced segments, one block each.  Its ``Y_I`` goes
to a per-segment scratch and each off-diagonal tile's transposed product
``K_IJᵀ V_I`` to a per-offset scratch at ``Y_J``'s rows; a second pass
sums the row parts by segment and then the column parts by offset.  The
emulation below runs that schedule (:func:`schedule`, a mirror of the
kernel's block order), those scratch layouts and that fixed-order sum, with
the kernel's arithmetic (unscaled norms, ``1/λ²`` folded into the exponent,
``θ²`` on the staged ``V``), and holds it to ``rbf_matvec_plain`` at the
f64 bar of ``chip_smoke.py`` (1e-12 relative).  The schedule itself must
cover each unordered pair exactly once and give every block the same work
within one tile, at the test sizes and at the main paths' n.  These are
checks of the design, mirrored here in Python: the card tests of
``tests/test_torch_cuda.py`` (``test_rbf_matvec_tile_edges``) are what
hold the kernel itself to the plain version.
"""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import rbf_matvec as rbf  # noqa: E402

SMS = 132  # the H100's SMs: the grid the wrapper sizes on the card
THETA = 3.0


def schedule(row_tiles, col_tiles, nseg, sym):
    """The blocks of one launch in the kernel's order:
    ``[(I, segment, [(o, J), ...]), ...]``.  Mirrors ``rbf_tiles`` in
    ``csrc/rbf_matvec.cu``: its block decode (``group``, ``in_group``,
    ``seg``, ``ti``, ``lo``, ``len``) and, per step, the offset rotated by
    I in the symmetric mode (``p``, ``o``, ``tj``).  Consecutive blocks take
    ``ROW_GROUP`` neighbouring row tiles a segment at a time."""
    lengths = rbf.sym_lengths(col_tiles) if sym else [col_tiles] * row_tiles
    blocks = []
    for b in range(row_tiles * nseg):
        group, in_group = divmod(b, rbf.ROW_GROUP * nseg)
        group_rows = min(rbf.ROW_GROUP, row_tiles - group * rbf.ROW_GROUP)
        seg = in_group // group_rows
        i = group * rbf.ROW_GROUP + in_group - seg * group_rows
        lo = seg * lengths[i] // nseg
        count = (seg + 1) * lengths[i] // nseg - lo
        tiles = []
        for step in range(count):
            o = lo + ((step - i) % count if sym else step)
            tiles.append((o, (i + o) % col_tiles if sym else o))
        blocks.append((i, seg, tiles))
    return blocks


def _grid(n, sms=SMS):
    t = rbf._runtime.cdiv(n, rbf.TILE)
    lengths = rbf.sym_lengths(t)
    return t, lengths, rbf._split_grid(t, lengths, sms)


def _emulate(x, v, theta, lengthscale, sms=SMS):
    """Y = K(X, X) V through the kernel's symmetric schedule and scratch."""
    n, r = x.shape[0], v.shape[1]
    t, lengths, nseg = _grid(n, sms)
    assert rbf._symmetric(n, lengths, r, x.element_size())
    chunk = rbf.MAX_R
    tile = rbf.TILE
    sq = (x * x).sum(1)
    inv_ls2 = 1.0 / (lengthscale * lengthscale)
    y = torch.empty_like(v)

    def rows(i):
        return slice(i * tile, min(n, (i + 1) * tile))

    for c0 in range(0, r, chunk):
        vs = theta**2 * v[:, c0 : c0 + chunk]
        rowpart = torch.zeros((nseg, n, vs.shape[1]), dtype=x.dtype)
        colpart = torch.full((max(lengths) - 1, n, vs.shape[1]), float("nan"), dtype=x.dtype)
        for i, seg, tiles in schedule(t, t, nseg, sym=True):
            ri = rows(i)
            ys = torch.zeros((ri.stop - ri.start, vs.shape[1]), dtype=x.dtype)
            for o, j in tiles:
                rj = rows(j)
                cross = x[ri] @ x[rj].T
                d2 = ((sq[ri, None] + sq[None, rj]) - 2.0 * cross) * inv_ls2
                k = torch.exp(-0.5 * d2.clamp(min=0.0))
                ys += k @ vs[rj]
                if o > 0:
                    colpart[o - 1, rj] = k.T @ vs[ri]
            rowpart[seg, ri] = ys
        out = rowpart[0].clone()
        for seg in range(1, nseg):
            out += rowpart[seg]
        # sum_parts: the row parts by segment, then the column parts by offset
        for row_tile in range(t):
            rj = rows(row_tile)
            for o in range(1, max(lengths)):
                if o < lengths[(row_tile - o) % t]:
                    out[rj] += colpart[o - 1, rj]
        y[:, c0 : c0 + chunk] = out
    return y


@pytest.mark.parametrize("r", [1, 8, 33])
@pytest.mark.parametrize("d", [3, 13, 784])
@pytest.mark.parametrize("n", [1, 63, 64, 65, 129, 300])
def test_symmetric_schedule_matches_plain(n, d, r):
    rng = np.random.default_rng(n * 1000 + d * 10 + r)
    x = torch.from_numpy(rng.random((n, d)))
    v = torch.from_numpy(rng.standard_normal((n, r)))
    ls = 3.0 * d**0.5 / 6.0
    got = _emulate(x, v, THETA, ls)
    want = rbf.rbf_matvec_plain(x, v, THETA, ls)
    scale = max(1.0, float(want.abs().max()))
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) / scale <= 1e-12


def test_symmetric_schedule_with_many_segments_and_row_groups():
    """A small SM count forces several segments a row and more than one
    row group (T = 17 > 16), so the rotation and both scratch passes run."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.random((2100, 16)))
    v = torch.from_numpy(rng.standard_normal((2100, 9)))
    t, _, nseg = _grid(2100, sms=3)
    assert t > rbf.ROW_GROUP and nseg > 1
    got = _emulate(x, v, THETA, 1.7, sms=3)
    want = rbf.rbf_matvec_plain(x, v, THETA, 1.7)
    assert float((got - want).abs().max()) / max(1.0, float(want.abs().max())) <= 1e-12


N_SCHEDULE = [1, 63, 64, 65, 128, 129, 256, 257, 300, 2100, 16384, 36551, 131072]


@pytest.mark.parametrize("sms", [SMS, 3])
@pytest.mark.parametrize("n", N_SCHEDULE)
def test_each_unordered_pair_once(n, sms):
    t, lengths, nseg = _grid(n, sms)
    blocks = schedule(t, t, nseg, sym=True)
    assert len(blocks) == t * nseg
    pairs = [tuple(sorted((i, j))) for i, _, tiles in blocks for _, j in tiles]
    assert len(pairs) == t * (t + 1) // 2
    assert set(pairs) == {(i, j) for i in range(t) for j in range(i, t)}
    # the diagonal tile comes from offset 0 of its own row, once
    assert sorted((i, o) for i, _, tiles in blocks for o, j in tiles if i == j) == [
        (i, 0) for i in range(t)]


@pytest.mark.parametrize("sms", [SMS, 3])
@pytest.mark.parametrize("n", N_SCHEDULE)
def test_blocks_get_equal_work_within_one_tile(n, sms):
    t, lengths, nseg = _grid(n, sms)
    work = [len(tiles) for _, _, tiles in schedule(t, t, nseg, sym=True)]
    assert max(work) - min(work) <= 1 and min(work) >= 1
    # each block's segment is a run of its row's offsets, walked once
    for i, seg, tiles in schedule(t, t, nseg, sym=True):
        offsets = sorted(o for o, _ in tiles)
        assert offsets == list(range(offsets[0], offsets[0] + len(offsets)))
        assert all(j == (i + o) % t for o, j in tiles)


@pytest.mark.parametrize("mn", [(4096, 16384), (2048, 16384), (9138, 36552), (1000, 3001),
                                (1, 5)])
def test_rectangular_schedule_covers_the_grid(mn):
    m, n = mn
    rt, ct = (rbf._runtime.cdiv(v, rbf.TILE) for v in mn)
    nseg = rbf._split_grid(rt, [ct], SMS)
    blocks = schedule(rt, ct, nseg, sym=False)
    tiles = [(i, j) for i, _, ts in blocks for _, j in ts]
    assert sorted(tiles) == list(itertools.product(range(rt), range(ct)))
    work = [len(ts) for _, _, ts in blocks]
    assert max(work) - min(work) <= 1


def test_concurrent_blocks_share_column_slabs():
    """One wave of consecutive blocks at the paper's n reads few distinct
    column tiles at each step (the rotation by I): the 128-row slabs of X
    they stream (d = 784, f64) fit the H100's 50 MB L2 together."""
    t, _, nseg = _grid(36551)
    wave = schedule(t, t, nseg, sym=True)[:SMS]
    rows = {i for i, _, _ in wave}
    for step in range(min(len(tiles) for _, _, tiles in wave)):
        cols = {tiles[step][1] for _, _, tiles in wave}
        assert len(cols) <= 2 * nseg
        assert (len(rows) + len(cols)) * rbf.TILE * 784 * 8 < 50e6


@pytest.mark.parametrize("r", [1, 8, 24])
def test_column_scratch_stays_under_a_gigabyte(r):
    """At the paper's n every r runs symmetric, 16 right-hand sides a pass,
    in less than the 1 GB budget."""
    t, lengths, _ = _grid(36551)
    assert rbf._symmetric(36551, lengths, r, 8)
    assert (max(lengths) - 1) * 36551 * min(r, rbf.MAX_R) * 8 < 1e9


@pytest.mark.parametrize("nr", [(131072, 1, True), (131072, 8, False), (131072, 24, False),
                                (44673, 16, False), (44672, 16, True), (178826, 1, True),
                                (178827, 1, False), (1_000_000, 1, False), (300, 33, True)])
def test_symmetric_mode_only_while_its_scratch_fits(nr):
    """Past the scratch budget the square product takes the full grid, so
    its scratch no longer grows as n²: at n = 131 072 (the scale phase)
    r = 1 stays symmetric, r = 8 and 24 run on the full grid."""
    n, r, sym = nr
    t = rbf._runtime.cdiv(n, rbf.TILE)
    lengths = rbf.sym_lengths(t)
    assert rbf._symmetric(n, lengths, r, 8) is sym
    if sym:
        assert (max(lengths) - 1) * n * min(r, rbf.MAX_R) * 8 <= rbf.SCRATCH_BYTES


def test_split_grid_fills_whole_waves_at_the_paper_n():
    t, lengths, nseg = _grid(36551)
    assert (t * nseg) % SMS == 0
