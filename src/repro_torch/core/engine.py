"""Krylov iteration harness (the counterpart of ``repro.core.engine``).

The reference runs a whole solve as one XLA program: a fixed-length
masked recording scan over the first ``ell`` iterations, then a
``while_loop``.  PyTorch runs eagerly, and a loop that reads its
convergence test back to the host every iteration waits on the card every
iteration.  So every step here is the MASKED step: ``active`` is computed
on the device, and a frozen step leaves the state untouched — the
iterates, iteration counts and matvec counts come out identical to the
reference's.  The host reads the convergence test once per
:data:`CHUNK` steps only, and never during the ``ell`` recording steps.

A frozen step still launches its product, and :func:`gated_matvec` hands
it the step's device ``active`` flag: an operator with a device gate (the
matrix-free RBF operator, whose K3 / K8 kernels read the flag vector
themselves) then skips the Gram tiles and returns zeros, as the
reference's gated ``cond`` does, with no host read.  An operator without
one (the dense ``torch.mv``, a callable) computes the product anyway and
the masked step discards it.  Either way a solve launches up to ``CHUNK
− 1`` products after convergence, none counted in ``matvecs``.

On the card the scalar recurrence of a step and its frozen-step mask run
inside the step's fused kernel: def-CG's from ``pᵀAp`` on is one
``fused_cg_update`` launch (``kernels.ops.fused_cg_step``), LSMR's after
``‖w‖²`` one ``lsmr_update`` launch (``kernels.ops.lsmr_step``).  Each
writes the next step's ``active`` flag, so ``active_fn`` there reads the
carried flag instead of launching the test.  The stall detector
(``stagnation_window > 0``) rides in the same launches: its ``(best,
stall)`` state is carried beside ``[j, fail]`` (:func:`stagnation_init`);
the sharded loops, whose tails run as eager ops, step it with
:func:`stagnation_update`.

One compiled program (the reference's ``jax.jit`` front doors): inside
:func:`compiled` (the ``*_jit`` doors enter it) a loop runs through
:class:`Program`, which on the card captures its ``ell`` recording steps
and a :data:`CHUNK` of steps as two CUDA graphs and replays them, the
host reading the convergence flag once a chunk as before.  A step never
closes over a solve's tensors: it takes them as ``consts`` (the
operators, the deflation products, the thresholds), and the loop state
carries everything a step writes.  A program copies both into buffers
of its own before the first replay, and keys the captured graphs on
what a step cannot read from a buffer (:func:`flatten`): shapes, strides,
dtypes, the static configuration, and each callable by its identity.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import threading
import types
import weakref
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import pytree as pt
# The breakdown and stall rules live beside the kernels whose step tails
# apply them.
from repro_torch.kernels import _runtime, cg_fused
from repro_torch.kernels.cg_fused import STAGNATION_RTOL, classify_breakdown  # noqa: F401

# Masked steps between two host reads of the convergence test.
CHUNK = 8


class SolveStatus:
    """Terminal status codes of an iterative solve (int32, as the reference)."""

    CONVERGED = 0
    MAXITER = 1
    BREAKDOWN_NONFINITE = 2
    BREAKDOWN_INDEFINITE = 3
    STAGNATED = 4

    @classmethod
    def describe(cls, code) -> str:
        """The status name of an int32 code (a Python int or 0-d tensor)."""
        code = int(code)
        for name in ("CONVERGED", "MAXITER", "BREAKDOWN_NONFINITE",
                     "BREAKDOWN_INDEFINITE", "STAGNATED"):
            if getattr(cls, name) == code:
                return name
        return f"UNKNOWN({code})"


class SolveInfo(NamedTuple):
    """Diagnostics of an iterative solve (0-d tensors on the solve's device)."""

    iterations: torch.Tensor
    converged: torch.Tensor
    residual_norm: torch.Tensor
    matvecs: torch.Tensor
    residual_norms: Optional[torch.Tensor] = None
    breakdown: torch.Tensor | bool = False
    status: torch.Tensor | int = 0
    guard_fired: torch.Tensor | bool = False


def exit_status(converged, fail):
    return torch.where(
        converged,
        SolveStatus.CONVERGED,
        torch.where(fail > 0, fail, SolveStatus.MAXITER),
    ).to(torch.int32)


def tolerances(b, tol, atol):
    bnorm = pt.tree_norm(b)
    return torch.clamp(tol * bnorm, min=atol), bnorm


def initial_fail(rnorm0):
    """A non-finite initial residual never enters the loop: flag it."""
    return torch.where(
        torch.isfinite(rnorm0), 0, SolveStatus.BREAKDOWN_NONFINITE
    ).to(torch.int32)


def trace_init(rnorm0, maxiter: int, record: bool):
    """NaN-tailed residual trace with slot 0 filled; ``None`` when off.

    One spare slot past ``maxiter + 1`` takes the writes of frozen steps
    at ``j == maxiter`` (the reference drops them); callers slice it off.
    A lane axis (``rnorm0`` ``(B,)``) gives one trace a lane.
    """
    if not record:
        return None
    trace = torch.full(
        rnorm0.shape + (maxiter + 2,), float("nan"), dtype=rnorm0.dtype, device=rnorm0.device
    )
    trace[..., 0] = rnorm0
    return trace


def stagnation_init(norm0, window: int):
    """The stall detector's ``(best, stall)`` before the first step —
    ``None`` when disarmed, so the clean path carries no extra state."""
    if window <= 0:
        return None
    return norm0, torch.zeros(norm0.shape, dtype=torch.int32, device=norm0.device)


def stagnation_update(stag, norm_new, fail, active, window: int):
    """One stall-detector step: ``(stag', fail')`` with STAGNATED latched
    into the sticky ``fail`` when the best residual has not improved by
    1 % for ``window`` consecutive active iterations (both unchanged when
    ``stag`` is None, the detector disarmed)."""
    if stag is None:
        return None, fail
    best, stall, fail = cg_fused.stagnation_update(*stag, norm_new, fail, active, window)
    return (best, stall), fail


def gated_matvec(apply, v, active):
    """A step's product behind its frozen-step gate, with no host read.

    ``active`` is the step's device flag (0-d), or the ``(B,)`` flags of a
    tenant batch whose ``v`` is ``(B, n)``: the product is skipped only
    once EVERY lane is frozen (the reference's cross-tenant ``psum``
    gate).  An operator offering ``gated_matvec(v, gate)`` is handed the
    flags and returns zeros when none is set; any other runs its product
    (the masked step discards a frozen one)."""
    gated = getattr(apply, "gated_matvec", None)
    if gated is None:
        return apply(v)
    return gated(v, active)


def run_recording_loop(
    step: Callable, active_fn: Callable, state: Tuple, *, ell: int = 0, consts: Any = None
):
    """Drive a method's masked steps.

    ``step(consts, state, active, row)`` runs one masked iteration; ``row``
    is the recording slot ``0 … ell−1`` during the first ``ell`` steps and
    ``None`` after.  Phase 1 runs those ``ell`` steps with no host read;
    phase 2 runs chunks of :data:`CHUNK` steps while the host-read
    ``active_fn(state)`` holds (for a batch's ``(B,)`` flags: while any
    lane is active).

    ``consts`` holds everything a step reads and no step writes (the
    operators, the deflation products, thresholds, static settings);
    anything a step writes in place belongs to ``state``.  Inside
    :func:`compiled` the loop runs as a :class:`Program` (captured CUDA
    graphs on the card), which needs ``step`` and ``active_fn`` to be
    module-level functions; a loop whose step closes over its inputs
    (``consts`` None: the sharded engine's, whose collectives run on the
    host) refuses to run there.
    """
    if _COMPILED.on:
        if consts is None:
            raise RuntimeError("this loop closes over its inputs and cannot run as one "
                               "compiled program; call its eager door")
        return _run_program(step, active_fn, state, ell, consts)
    for row in range(ell):
        state = step(consts, state, active_fn(state), row)
    while _any_active(active_fn(state)):
        for _ in range(CHUNK):
            state = step(consts, state, active_fn(state), None)
    return state


def _any_active(active) -> bool:
    """The host read of a chunk: the flag, or any lane's of a batch."""
    return bool(active) if active.ndim == 0 else bool(torch.any(active))


# ---------------------------------------------------------------------------
# One compiled program: the captured loop of the *_jit doors
# ---------------------------------------------------------------------------

# Most programs kept at once (least recently used evicted first); each
# holds its share of the buffers and, on the card, its two graphs.
MAX_PROGRAMS = 16

# What the doors ran, for tests and the chip smoke: programs built and
# reused, graphs captured and replayed (card), programs run step by step
# through the buffers (CPU), loops run eagerly because an input declares
# host state.
GRAPHS = dict.fromkeys(("built", "reused", "captured", "replays", "buffered", "host_state"), 0)


class _Mode(threading.local):
    on = False


_COMPILED = _Mode()
_PROGRAMS: "collections.OrderedDict[tuple, Program]" = collections.OrderedDict()
_NODES: dict = {}


class _HostStateError(TypeError):
    """An input of a loop keeps state on the host that a replay would not
    update (``host_state = True``)."""


@contextlib.contextmanager
def compiled():
    """Run every masked loop inside as one compiled program (:class:`Program`)."""
    prev = _COMPILED.on
    _COMPILED.on = True
    try:
        yield
    finally:
        _COMPILED.on = prev


def compiled_door(fn: Callable, doc: str) -> Callable:
    """``fn`` with its loops run as compiled programs: the port's ``*_jit``."""

    @functools.wraps(fn)
    def door(*args, **kwargs):
        with compiled():
            return fn(*args, **kwargs)

    door.__doc__ = doc
    door.__name__ = door.__qualname__ = fn.__name__.lstrip("_") + "_jit"
    return door


def reset_graph_stats() -> None:
    for key in GRAPHS:
        GRAPHS[key] = 0


def clear_programs() -> None:
    """Drop every cached program (its buffers and graphs)."""
    while _PROGRAMS:
        _PROGRAMS.popitem()[1].release()


def register_node(cls, flatten_fn: Callable, unflatten_fn: Callable) -> None:
    """Declare how a loop input of type ``cls`` splits, as a pytree node of
    the reference does: ``flatten_fn(obj) -> (children, aux)`` with the
    tensors (traced, copied into the program's buffers) among
    ``children`` and the static data in the tuple ``aux`` (values, and
    callables hashed by identity), ``unflatten_fn(aux, children)`` the
    inverse."""
    _NODES[cls] = (flatten_fn, unflatten_fn)


_STATIC_TYPES = (bool, int, float, str, torch.dtype, torch.device)


def flatten(tree, leaves: list, objs: list, idents: list, strides: bool = True):
    """``tree``'s key, its tensors appended to ``leaves``.

    A tensor is a leaf (keyed by shape, dtype, device and, with
    ``strides``, its strides: a state leaf's layout may change from step to
    step, and its buffer keeps the first one's); None,
    numbers, strings, dtypes and devices are static values; tuples, lists
    and dicts recurse; a registered node (:func:`register_node`) splits
    into children and static aux; any other callable is static by
    identity (a bare closure: the graph reads what it closes over where it
    was at capture).  ``objs`` collects what :func:`unflatten` needs back
    (aux tuples, callables), ``idents`` the objects keyed by identity.
    Anything declaring ``host_state`` raises :class:`_HostStateError`.
    """
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return ("T", tuple(tree.shape), tree.stride() if strides else None, tree.dtype,
                tree.device)
    if tree is None or isinstance(tree, _STATIC_TYPES):
        return ("V", type(tree), tree)
    if getattr(tree, "host_state", False):
        raise _HostStateError(f"{type(tree).__name__} keeps state on the host")
    if isinstance(tree, (tuple, list)):
        return ("S", type(tree), tuple(flatten(t, leaves, objs, idents, strides)
                                       for t in tree))
    if isinstance(tree, dict):
        keys = tuple(tree)
        return ("D", keys, tuple(flatten(tree[k], leaves, objs, idents, strides)
                                 for k in keys))
    node = _NODES.get(type(tree))
    if node is not None:
        children, aux = node[0](tree)
        objs.append(aux)
        return ("R", type(tree), tuple(_static_key(a, idents) for a in aux),
                flatten(children, leaves, objs, idents, strides))
    if callable(tree):
        objs.append(tree)
        return ("C", _static_key(tree, idents))
    raise TypeError(f"a compiled loop cannot take a {type(tree).__name__}: register it with "
                    "engine.register_node or pass a callable")


def unflatten(key, leaves, objs):
    """The inverse of :func:`flatten` over iterators of leaves and objs."""
    tag = key[0]
    if tag == "T":
        return next(leaves)
    if tag == "V":
        return key[2]
    if tag == "S":
        items = [unflatten(k, leaves, objs) for k in key[2]]
        return key[1](*items) if hasattr(key[1], "_fields") else key[1](items)
    if tag == "D":
        return {name: unflatten(k, leaves, objs) for name, k in zip(key[1], key[2])}
    if tag == "R":
        aux = next(objs)
        return _NODES[key[1]][1](aux, unflatten(key[3], leaves, objs))
    return next(objs)


def _static_key(obj, idents: list):
    """A static value's part of the key: the value itself, or a callable's
    identity (a bound method's by its object and function)."""
    if obj is None or isinstance(obj, _STATIC_TYPES):
        return obj
    if isinstance(obj, torch.Tensor):
        raise TypeError("a tensor in a node's static aux data: make it a child")
    if getattr(obj, "host_state", False):
        raise _HostStateError(f"{type(obj).__name__} keeps state on the host")
    if isinstance(obj, types.MethodType):
        idents.append(obj.__self__)
        return ("method", id(obj.__self__), obj.__func__)
    idents.append(obj)
    return ("id", id(obj))


def _run_program(step, active_fn, state, ell: int, consts):
    leaves: list = []
    objs: list = []
    idents: list = []
    try:
        c_key = flatten(consts, leaves, objs, idents)
    except _HostStateError:
        # The reference reaches such an operator through io_callback; a
        # replay runs no Python, so the loop runs its eager steps.
        GRAPHS["host_state"] += 1
        with _eager():
            return run_recording_loop(step, active_fn, state, ell=ell, consts=consts)
    s_leaves: list = []
    s_key = flatten(state, s_leaves, [], [], strides=False)
    key = (step, active_fn, ell, CHUNK, c_key, s_key)
    prog = _PROGRAMS.get(key)
    if prog is None:
        prog = Program(key, step, active_fn, ell, c_key, s_key, leaves, objs, s_leaves, idents)
        GRAPHS["built"] += 1
    else:
        _PROGRAMS.move_to_end(key)
        GRAPHS["reused"] += 1
    return prog.run(leaves, objs, s_leaves)


@contextlib.contextmanager
def _eager():
    prev = _COMPILED.on
    _COMPILED.on = False
    try:
        yield
    finally:
        _COMPILED.on = prev


def _evict(key) -> None:
    prog = _PROGRAMS.pop(key, None)
    if prog is not None:
        prog.release()


# Buffers by layout (shape, strides, dtype, device), weakly held: the i-th
# leaf of a layout in any program takes the i-th buffer of that layout.
_ARENA: dict = {}


def _buffers(leaves) -> list:
    """One buffer a leaf, shared with every other program's leaf of the same
    layout and ordinal.  Safe because a run copies all its inputs in before
    its replays and its state out after them, and runs never overlap, so a
    program's buffers only hold its data while it runs; memory grows with
    the layouts in use, not the programs (every Newton system's program of
    the matrix-free operator shares one copy of ``x``)."""
    taken: dict = {}
    out = []
    for t in leaves:
        layout = (tuple(t.shape), t.stride(), t.dtype, t.device)
        i = taken[layout] = taken.get(layout, -1) + 1
        refs = _ARENA.setdefault(layout, [])
        buf = refs[i]() if i < len(refs) else None
        if buf is None:
            buf = torch.empty_strided(t.shape, t.stride(), dtype=t.dtype, device=t.device)
            if i < len(refs):
                refs[i] = weakref.ref(buf)
            else:
                refs.append(weakref.ref(buf))
        out.append(buf)
    return out


@functools.lru_cache(maxsize=None)
def _capture_stream(device: torch.device):
    """The side stream every capture (and its warm-up) runs on."""
    return torch.cuda.Stream(device)



class Program:
    """One loop shape as a compiled program: the buffers and, on the card,
    the captured graphs of :func:`run_recording_loop`'s two phases.

    Built on the first solve of its key: the buffers take copies of that
    solve's ``consts`` and state leaves.  On a CUDA device one eager
    warm-up step of each phase runs on the capture stream (it allocates
    the step kernels' scratch and cuBLAS's workspace outside any graph),
    the buffers are loaded again, and the ``ell`` recording steps and a
    :data:`CHUNK` of steps are captured as two graphs, each ending with
    the copy of the new state into the state buffers.  Every later solve
    of the key copies its inputs into the buffers and replays: the
    recording graph once, then the chunk graph while the host read of the
    active flag holds.  Programs share their buffers by layout
    (:func:`_buffers`).  On the CPU the same buffers run the eager
    steps in the same groups (the plumbing the CPU tests check).  A replay
    adds the launches its capture counted to the kernels' counters
    (:mod:`repro_torch.kernels._runtime`).

    The program holds no reference to the callables of its key: each is
    watched by a weak reference that evicts the program when it dies (a
    closure's tensors, which the graph reads in place, die with it).  The
    step kernels' reduction scratch and ticket counters
    (``kernels.cg_fused._reduce_scratch``) are allocated once a device,
    dtype and lane count, before any capture (the warm-up), and never
    again, so no graph outlives the scratch it reads; the replays run on
    the caller's stream, after its eager launches, never beside them.
    """

    def __init__(self, key, step, active_fn, ell, c_key, s_key, c_leaves, objs, s_leaves,
                 idents):
        self.step, self.active_fn, self.ell = step, active_fn, ell
        self.c_key, self.s_key = c_key, s_key
        bufs = _buffers(c_leaves + s_leaves)
        self.c_buf, self.s_buf = bufs[:len(c_leaves)], bufs[len(c_leaves):]
        self.state = unflatten(s_key, iter(self.s_buf), iter(()))
        self.device = (c_leaves + s_leaves)[0].device
        self.graphs = {}
        if self.device.type == "cuda":
            self._capture(c_leaves, objs, s_leaves)
        self.pins, self.watches = [], []
        for obj in idents:
            try:
                self.watches.append(weakref.finalize(obj, _evict, key))
            except TypeError:  # not weakly referenceable: keep it alive
                self.pins.append(obj)
        while len(_PROGRAMS) >= MAX_PROGRAMS:
            _PROGRAMS.popitem(last=False)[1].release()
        _PROGRAMS[key] = self

    def release(self) -> None:
        """Stop watching the key's callables (the program left the cache)."""
        for watch in self.watches:
            watch.detach()

    def _load(self, c_leaves, s_leaves) -> None:
        for buf, t in zip(self.c_buf + self.s_buf, c_leaves + s_leaves):
            if buf is not t:
                buf.copy_(t)

    def _steps(self, consts, rows) -> None:
        """The steps of one phase on the buffers, ending in the copy of the
        new state into the state buffers."""
        state = self.state
        for row in rows:
            state = self.step(consts, state, self.active_fn(state), row)
        out: list = []
        if flatten(state, out, [], [], strides=False) != self.s_key:
            raise RuntimeError("a compiled loop's step changed its state's layout")
        for buf, t in zip(self.s_buf, out):
            if buf is not t:
                buf.copy_(t)

    def _phases(self) -> dict:
        """The rows of the recording phase (absent when ``ell`` is 0) and of a
        chunk."""
        phases = {"rec": list(range(self.ell))} if self.ell else {}
        phases["chunk"] = [None] * CHUNK
        return phases

    def _capture(self, c_leaves, objs, s_leaves) -> None:
        consts = unflatten(self.c_key, iter(self.c_buf), iter(objs))
        stream = _capture_stream(self.device)
        phases = self._phases()
        self._load(c_leaves, s_leaves)
        versions = [t._version for t in self.c_buf]
        torch.cuda.synchronize(self.device)
        with torch.cuda.stream(stream):
            for rows in phases.values():  # warm-up: one eager step a phase
                state = self.state
                self.step(consts, state, self.active_fn(state), rows[0])
        torch.cuda.synchronize(self.device)
        # One pool for the program's two graphs (a handle outlives the pool
        # once its graphs are gone, so programs cannot share one).
        pool = torch.cuda.graph_pool_handle()
        for name, rows in phases.items():
            graph = torch.cuda.CUDAGraph()
            before = _launch_counts()
            with torch.cuda.stream(stream):
                graph.capture_begin(pool=pool)
                try:
                    self._steps(consts, rows)
                except BaseException:
                    try:
                        graph.capture_end()
                    except RuntimeError:
                        pass  # the capture was invalidated by the error below
                    _restore_launch_counts(before)
                    raise
                graph.capture_end()
            self.graphs[name] = (graph, _launch_delta(before))
            _restore_launch_counts(before)
            GRAPHS["captured"] += 1
        torch.cuda.synchronize(self.device)
        if [t._version for t in self.c_buf] != versions:
            raise RuntimeError("a compiled loop's step wrote into its consts; what a step "
                               "writes belongs to the loop state")

    def run(self, c_leaves, objs, s_leaves):
        """One solve's loop on this program: its inputs in, the final state
        out (copies: the buffers belong to the next solve)."""
        self._load(c_leaves, s_leaves)
        if self.graphs:
            if self.ell:
                self._replay("rec")
            while _any_active(self.active_fn(self.state)):
                self._replay("chunk")
        else:
            consts = unflatten(self.c_key, iter(self.c_buf), iter(objs))
            phases = self._phases()
            if self.ell:
                self._steps(consts, phases["rec"])
                GRAPHS["buffered"] += 1
            while _any_active(self.active_fn(self.state)):
                self._steps(consts, phases["chunk"])
                GRAPHS["buffered"] += 1
        return unflatten(self.s_key, iter([t.clone() for t in self.s_buf]), iter(()))

    def _replay(self, name: str) -> None:
        graph, delta = self.graphs[name]
        graph.replay()
        GRAPHS["replays"] += 1
        for table, counts in delta:
            for k, v in counts.items():
                table[k] = table.get(k, 0) + v


def _launch_counts():
    return [(table, dict(table)) for table in (_runtime.LAUNCHES, _runtime.ARMS,
                                               _runtime.PLAIN_ON_CUDA)]


def _launch_delta(before):
    return [(table, {k: v - old.get(k, 0) for k, v in table.items() if v != old.get(k, 0)})
            for table, old in before]


def _restore_launch_counts(before) -> None:
    for table, old in before:
        table.clear()
        table.update(old)


def psum_merged(parts, mesh):
    """Batch several small reductions into ONE ``all_reduce``.

    ``parts`` are per-rank partial reductions (0-d or 1-d tensors, e.g.
    ``[pᵀap, rᵀap, apᵀap, AW@ap]``): packed into one flat buffer of their
    common dtype, summed over ``mesh``'s ranks by one collective
    (:meth:`repro_torch.launch.SolveMesh.all_reduce`, which counts it), and
    unpacked to their own shapes and dtypes.  Every in-loop reduction of
    the sharded engine rides this one call: one all-reduce per cg / def-CG
    iteration, two per LSMR iteration (DESIGN.md §5).
    """
    dtype = parts[0].dtype
    for p in parts[1:]:
        dtype = torch.promote_types(dtype, p.dtype)
    flats = [p.reshape(-1).to(dtype) for p in parts]
    red = mesh.all_reduce(torch.cat(flats))
    out, off = [], 0
    for p, f in zip(parts, flats):
        out.append(red[off : off + f.numel()].reshape(p.shape).to(p.dtype))
        off += f.numel()
    return out
