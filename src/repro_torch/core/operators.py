"""Linear operators on flat tensors.

The SPD solvers touch ``A`` only through ``A @ v``; LSMR touches a
rectangular ``A`` through ``A v`` and ``Aᵀ u``.  The port has a callable
wrapper (symmetric, or rectangular with an adjoint), a dense matrix, the
paper's Newton-system operator ``A = I + H½ K H½`` over any ``K`` product
and over the matrix-free RBF Gram kernel, and the two operators of
Hessian-free training: the damped GGN ``JᵀH_LJ + λI`` and the
Gauss-Newton Jacobian ``J`` of a residual map.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable, Optional

import torch

from repro_torch.core import engine
from repro_torch.core import pytree as pt
from repro_torch.kernels import ops as kops

Matvec = Callable[[torch.Tensor], torch.Tensor]


@dataclasses.dataclass
class LinearOperator:
    """A linear operator ``v ↦ A v`` — symmetric by default, rectangular
    when an adjoint is supplied.

    Attributes:
      matvec: the matvec closure on ``(n,)`` tensors.
      matvec_cost_flops: optional estimate of flops per matvec.
      matmat: optional multi-RHS closure ``V ↦ A V`` over column-stacked
        ``(n, r)`` tensors; :func:`apply_to_basis` then refreshes a whole
        basis in one operator application.
      rmatvec: optional adjoint closure ``u ↦ Aᵀ u``.  ``None`` declares
        the operator symmetric (every SPD path assumes it), and :attr:`T`
        is then the operator itself.
    """

    matvec: Matvec
    matvec_cost_flops: Optional[float] = None
    matmat: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
    rmatvec: Optional[Matvec] = None

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        return self.matvec(v)

    def __matmul__(self, v: torch.Tensor) -> torch.Tensor:
        return self.matvec(v)

    @property
    def T(self) -> "LinearOperator":
        """The adjoint ``u ↦ Aᵀ u`` (the operator itself when symmetric)."""
        if self.rmatvec is None:
            return self
        return LinearOperator(self.rmatvec, self.matvec_cost_flops, None, self.matvec)

    def basis_matvec(self, basis: torch.Tensor) -> torch.Tensor:
        """``A`` on every row of an ``(m, n)`` basis."""
        if self.matmat is not None:
            return self.matmat(basis.T).T
        return torch.stack([self.matvec(v) for v in basis])


class DenseMatrixOperator(LinearOperator):
    """An explicit ``(m, n)`` matrix as an operator.

    ``matvec`` maps ``(n,) → (m,)``; :attr:`rmatvec` and :attr:`T` apply
    ``matᵀ`` (a transposed view, no copy), which is what LSMR consumes.
    Square SPD use is unchanged: the SPD solvers never call ``rmatvec``.
    """

    def __init__(self, mat: torch.Tensor):
        self.mat = mat
        m, n = mat.shape[-2], mat.shape[-1]
        self.domain_size = n

        def mv(v):
            return mat @ v

        def rmv(u):
            return mat.transpose(-2, -1) @ u

        super().__init__(mv, matvec_cost_flops=2.0 * m * n, matmat=mv, rmatvec=rmv)

    @property
    def T(self) -> "DenseMatrixOperator":
        return DenseMatrixOperator(self.mat.transpose(-2, -1))


def from_matrix(mat: torch.Tensor) -> DenseMatrixOperator:
    """Explicit dense matrix as an operator over flat ``(n,)`` vectors."""
    return DenseMatrixOperator(mat)


def from_callable(fn: Matvec, cost: Optional[float] = None) -> LinearOperator:
    return LinearOperator(fn, cost)


def apply_to_basis(op, basis: torch.Tensor) -> torch.Tensor:
    """``A`` on an ``(m, n)`` basis as ONE multi-RHS application where the
    operator offers ``basis_matvec``; a row-by-row sweep otherwise."""
    bm = getattr(op, "basis_matvec", None)
    if bm is not None:
        return bm(basis)
    return torch.stack([op(v) for v in basis])


@dataclasses.dataclass
class KernelSystemOperator:
    """``A v = v + H½ · K (H½ · v)`` — the Kuss–Rasmussen Newton system.

    ``kernel_matvec`` computes ``K u`` for ``(n,)`` and column-stacked
    ``(n, r)`` inputs (a dense ``K @ V`` does both); ``sqrt_h`` is the
    diagonal of ``H½``.
    """

    kernel_matvec: Matvec
    sqrt_h: torch.Tensor
    matvec_cost_flops: Optional[float] = None

    def matvec(self, v: torch.Tensor) -> torch.Tensor:
        """``A v`` for ``v`` (n,); with a tenant batch (``sqrt_h`` (B, n),
        tenants sharing ``K``) ``v`` is ``(B, n)`` and ``K`` runs ONCE on
        the ``(n, B)`` stack ``(H½ ⊙ V)ᵀ``."""
        if v.ndim == 2:
            return v + self.sqrt_h * self.kernel_matvec((self.sqrt_h * v).T).T
        return v + self.sqrt_h * self.kernel_matvec(self.sqrt_h * v)

    def basis_matvec(self, basis: torch.Tensor) -> torch.Tensor:
        """``A`` on an ``(m, n)`` basis — one multi-RHS kernel product; on a
        tenant batch a ``(B, m, n)`` basis, one product of ``B·m`` columns."""
        if basis.ndim == 3:
            h = self.sqrt_h[:, None, :]
            u = (basis * h).reshape(-1, basis.shape[-1]).T  # (n, B·m)
            return basis + h * self.kernel_matvec(u).T.reshape(basis.shape)
        v = (basis * self.sqrt_h[None, :]).T  # (n, m) column-stacked
        return basis + self.sqrt_h[None, :] * self.kernel_matvec(v).T

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        return self.matvec(v)

    def __matmul__(self, v: torch.Tensor) -> torch.Tensor:
        return self.matvec(v)


class RBFKernelSystemOperator(KernelSystemOperator):
    """``A v = v + H½ · K(X, X) (H½ · v)`` with ``K`` never formed.

    :class:`KernelSystemOperator` over the RBF Gram kernel, holding its
    data (``x``, ``sqrt_h``) and hyperparameters as attributes: every
    product is one call of the fused Gram matvec
    (:func:`repro_torch.kernels.ops.rbf_matvec`, the K3 kernel on the
    card), so :meth:`basis_matvec` refreshes a whole ``(m, n)`` basis in
    one multi-RHS call.
    """

    def __init__(
        self,
        x: torch.Tensor,  # (n, d) training inputs
        sqrt_h: torch.Tensor,  # (n,) H½ diagonal
        theta: float = 1.0,
        lengthscale: float = 1.0,
        block: int = 1024,
        backend: str = "auto",
    ):
        self.x, self.theta, self.lengthscale = x, theta, lengthscale
        self.block, self.backend = block, backend
        super().__init__(self._rbf_matvec, sqrt_h)

    def _rbf_matvec(self, u: torch.Tensor, gate: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``K(X, X) @ u`` — (n,) or column-stacked (n, r); zeros when
        ``gate`` (device flags) holds no set flag."""
        return kops.rbf_matvec(
            self.x, u, self.theta, self.lengthscale,
            backend=self.backend, block=self.block, gate=gate,
        )

    def gated_matvec(self, v: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
        """:meth:`matvec` behind a device gate: zeros when no flag of
        ``gate`` (0-d, or a tenant batch's ``(B,)``) is set, the K3 kernel
        skipping its Gram tiles on the card; bit for bit :meth:`matvec`
        when one is.  No host read."""
        on = gate if gate.ndim == 0 else torch.any(gate)
        v_on = torch.where(on, v, 0.0)
        if v.ndim == 2:
            return v_on + self.sqrt_h * self._rbf_matvec((self.sqrt_h * v).T, gate).T
        return v_on + self.sqrt_h * self._rbf_matvec(self.sqrt_h * v, gate)


# ---------------------------------------------------------------------------
# Hessian-free training: the damped GGN and the Gauss-Newton Jacobian
# ---------------------------------------------------------------------------


def _flat_fn(fn: Callable[[Any], Any], unravel, flatten_out: bool):
    """``fn`` of the flat parameter vector (``fn ∘ unravel``); its output
    raveled (:func:`repro_torch.core.pytree.ravel`) when ``flatten_out``."""
    if flatten_out:
        return lambda p: pt.ravel(fn(unravel(p)))
    return lambda p: fn(unravel(p))


@dataclasses.dataclass
class GGNOperator:
    """Damped generalized Gauss-Newton matvec ``(Jᵀ H_L J + λ I) v``.

    ``model_fn(params) -> outputs`` is the network up to its final
    outputs and ``loss_hvp(outputs, tangent_out)`` applies the loss
    Hessian; ``params`` is a tensor or a dict of tensors.  The operator
    acts on FLAT ``(n,)`` vectors in :func:`repro_torch.core.pytree.ravel`
    order (dict keys sorted, as JAX ravels them), so a recycled basis
    means the same coordinates as the reference's.  One matvec is one
    ``torch.func.jvp``, one loss-Hessian apply and one ``torch.func.vjp``.
    ``damping`` may be a 0-d tensor of another dtype (the f32 LM damping
    of :func:`repro_torch.optim.hf_step`); ``damping · v`` promotes as the
    reference's ``tree_axpy`` does.
    """

    model_fn: Callable[[Any], Any]
    loss_hvp: Callable[[Any, Any], Any]
    params: Any
    damping: Any = 0.0

    def __post_init__(self):
        self._p, unravel = pt.ravel_vector(self.params)
        self._f = _flat_fn(self.model_fn, unravel, flatten_out=False)
        self.domain_size = self._p.shape[0]

    def matvec(self, v: torch.Tensor) -> torch.Tensor:
        outputs, jv = torch.func.jvp(self._f, (self._p,), (v,))
        _, vjp_fn = torch.func.vjp(self._f, self._p)
        (gv,) = vjp_fn(self.loss_hvp(outputs, jv))
        return gv + self.damping * v

    def basis_matvec(self, basis: torch.Tensor) -> torch.Tensor:
        """The GGN on every row of an ``(m, n)`` basis: the model is
        linearized ONCE (``torch.func.linearize``) and one ``vjp`` closure
        serves every row — two forward passes in all, not 2m."""
        with warnings.catch_warnings():
            # linearize traces the tangent map with make_fx, whose constant
            # folding warns about the captured batch tensors; harmless.
            warnings.simplefilter("ignore", UserWarning)
            outputs, jvp_fn = torch.func.linearize(self._f, self._p)
        _, vjp_fn = torch.func.vjp(self._f, self._p)
        rows = [vjp_fn(self.loss_hvp(outputs, jvp_fn(v)))[0] for v in basis]
        return torch.stack(rows) + self.damping * basis

    def __call__(self, v):
        return self.matvec(v)

    def __matmul__(self, v):
        return self.matvec(v)


@dataclasses.dataclass
class GaussNewtonOperator:
    """The Jacobian ``J`` of a residual map as a rectangular operator.

    ``residual_fn(params) -> residuals`` (a tensor of any shape, or a dict
    of them); the operator maps flat ``(n,)`` parameter vectors to flat
    ``(m,)`` residual vectors, both in :func:`pt.ravel` order, through the
    two products LSMR consumes:

    * ``matvec(v) = J v`` — one ``torch.func.jvp``;
    * ``rmatvec(u) = Jᵀ u`` — one ``torch.func.vjp``.

    Solving ``min ‖J δ + r‖² + λ‖δ‖²`` with :func:`repro_torch.core.lsmr`
    is the true Gauss-Newton step: conditioning κ(J), not κ(J)² as in the
    normal-equations operator :class:`GGNOperator` hands to CG.
    """

    residual_fn: Callable[[Any], Any]
    params: Any

    def __post_init__(self):
        self._p, unravel = pt.ravel_vector(self.params)
        self._f = _flat_fn(self.residual_fn, unravel, flatten_out=True)
        self.domain_size = self._p.shape[0]

    def matvec(self, v: torch.Tensor) -> torch.Tensor:
        return torch.func.jvp(self._f, (self._p,), (v,))[1]

    def rmatvec(self, u: torch.Tensor) -> torch.Tensor:
        _, vjp_fn = torch.func.vjp(self._f, self._p)
        return vjp_fn(u)[0]

    def residuals(self) -> torch.Tensor:
        """``r(params)``, flat — the right-hand side is ``−r`` for a GN step."""
        return self._f(self._p)

    @property
    def T(self) -> LinearOperator:
        return LinearOperator(self.rmatvec, rmatvec=self.matvec)

    def __call__(self, v):
        return self.matvec(v)

    def __matmul__(self, v):
        return self.matvec(v)


def materialize(op, template: Any) -> torch.Tensor:
    """The dense matrix of a small operator ``op`` (a callable on vectors
    shaped like ``template``, a tensor or a pytree) in the coordinates of
    ``template``'s raveled vector: column i is ``op`` of the i-th unit
    vector.  For tests."""
    flat, unravel = pt.ravel_vector(template)
    eye = torch.eye(flat.numel(), dtype=flat.dtype, device=flat.device)
    return torch.stack([pt.ravel(op(unravel(e))) for e in eye], dim=1)


def adjoint_matvec(op) -> Matvec:
    """The ``u ↦ Aᵀ u`` closure of ``op``: its ``rmatvec`` where it has
    one; otherwise the operator is symmetric by this repo's contract and
    its adjoint is its own matvec."""
    rmv = getattr(op, "rmatvec", None)
    if rmv is not None:
        return rmv
    return op.matvec if hasattr(op, "matvec") else op


# ---------------------------------------------------------------------------
# Tenant batches: B systems' products on (B, n) stacks
# ---------------------------------------------------------------------------


def over_lanes(one, batched, lanes: bool, *args):
    """``one`` (a one-system function) on ``args``, or with ``lanes`` on
    each lane of their leading axis: lane by lane on the CPU, so a lane
    computes exactly as its one-system solve does, and as ONE ``batched``
    call on the card (one launch for all lanes; its order is not cuBLAS's
    one-system order, so there a lane agrees with its sequential solve to
    rounding)."""
    if not lanes:
        return one(*args)
    if args[0].device.type == "cpu":
        return stack_lanes([one(*(a[i] for a in args)) for i in range(args[0].shape[0])])
    return batched(*args)


def stack_lanes(outs):
    """The lanes' one-system results on a new leading axis, each lane in its
    result's memory layout: a LAPACK result or a transposed product is
    column-major, and a product that reads it then takes the one-system
    BLAS path (and rounding)."""
    if outs[0].ndim == 2 and not outs[0].is_contiguous() and outs[0].T.is_contiguous():
        return torch.stack([o.T for o in outs]).transpose(-2, -1)
    return torch.stack(outs)


class LaneOperator:
    """B tenants' operators on ``(B, n)`` stacks, one row a tenant: the
    operator of :func:`repro_torch.core.solve_batch`.

    ``matvec(V)`` → ``(B, m)``; ``rmatvec(U)`` → ``(B, n)`` (each tenant's
    adjoint, :func:`adjoint_matvec`: batched least squares); ``basis_matvec(W)``
    on ``(B, k, n)``; ``gated_matvec(V, active)`` behind the tenants' ``(B,)``
    device flags.  One product per tenant; :func:`lane_operator` and
    :class:`LaneDenseOperator` keep one product per iteration where the
    tenants share their operator's data.
    """

    def __init__(self, ops):
        self.ops = list(ops)
        n = getattr(self.ops[0], "domain_size", None)
        if n is not None:
            self.domain_size = n

    def matvec(self, v: torch.Tensor) -> torch.Tensor:
        return torch.stack([op(v[i]) for i, op in enumerate(self.ops)])

    def rmatvec(self, u: torch.Tensor) -> torch.Tensor:
        return torch.stack([adjoint_matvec(op)(u[i]) for i, op in enumerate(self.ops)])

    @property
    def T(self) -> "LaneOperator":
        """The tenants' adjoints (each tenant's ``T``, or its adjoint
        closure)."""
        return LaneOperator([op.T if hasattr(op, "T") else adjoint_matvec(op)
                             for op in self.ops])

    def basis_matvec(self, basis: torch.Tensor) -> torch.Tensor:
        return stack_lanes([apply_to_basis(op, basis[i]) for i, op in enumerate(self.ops)])

    def gated_matvec(self, v: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
        rows = []
        for i, op in enumerate(self.ops):
            gated = getattr(op, "gated_matvec", None)
            rows.append(op(v[i]) if gated is None else gated(v[i], active[i]))
        return torch.stack(rows)

    def __call__(self, v):
        return self.matvec(v)


def _mv(mat, v):
    return mat @ v


def _batched_mv(mats, v):
    return torch.matmul(mats, v[..., None])[..., 0]


def _basis_mv(mat, basis):
    return (mat @ basis.T).T


def _batched_basis_mv(mats, basis):
    return torch.matmul(basis, mats.transpose(-2, -1))


class LaneDenseOperator(LaneOperator):
    """B tenants' dense matrices, the rows of one ``(B, m, n)`` tensor
    (square or rectangular; held as given, no copy).

    Through :func:`over_lanes`: ONE batched product of ``Aᵢ vᵢ`` (``Aᵢᵀ uᵢ``
    for the adjoint) on the card, tenant by tenant on the CPU, where each
    lane multiplies as its own :class:`DenseMatrixOperator` does."""

    def __init__(self, mats: torch.Tensor):
        super().__init__([DenseMatrixOperator(mat) for mat in mats.unbind(0)])
        self.mats = mats

    def matvec(self, v: torch.Tensor) -> torch.Tensor:
        return over_lanes(_mv, _batched_mv, True, self.mats, v)

    def rmatvec(self, u: torch.Tensor) -> torch.Tensor:
        return self.T.matvec(u)

    @property
    def T(self) -> "LaneDenseOperator":
        return LaneDenseOperator(self.mats.transpose(-2, -1))

    def basis_matvec(self, basis: torch.Tensor) -> torch.Tensor:
        return over_lanes(_basis_mv, _batched_basis_mv, True, self.mats, basis)


def lane_operator(ops):
    """The batched operator of B tenants' operators ``ops``.

    Tenants sharing a kernel product (``KernelSystemOperator`` with one
    ``kernel_matvec``; ``RBFKernelSystemOperator`` over one ``x`` and the
    same hyperparameters) become ONE ``KernelSystemOperator`` whose
    ``sqrt_h`` is ``(B, n)``: ``K`` runs once per iteration on the
    ``(n, B)`` stack (one matmul dense, one K3 call of r = B matrix-free,
    gated by the tenants' flags).  Anything else runs tenant by tenant
    (stacked dense tenants come as one :class:`LaneDenseOperator`)."""
    first = ops[0]
    if all(type(op) is RBFKernelSystemOperator for op in ops) and all(
        op.x is first.x and (op.theta, op.lengthscale, op.block, op.backend)
        == (first.theta, first.lengthscale, first.block, first.backend) for op in ops
    ):
        return RBFKernelSystemOperator(first.x, torch.stack([op.sqrt_h for op in ops]),
                                       first.theta, first.lengthscale, first.block,
                                       first.backend)
    if all(type(op) is KernelSystemOperator for op in ops) and all(
        op.kernel_matvec is first.kernel_matvec for op in ops
    ):
        return KernelSystemOperator(first.kernel_matvec, torch.stack([op.sqrt_h for op in ops]))
    return LaneOperator(ops)


# ---------------------------------------------------------------------------
# The operators as loop inputs of a compiled program (engine.register_node)
# ---------------------------------------------------------------------------
#
# The reference's pytree split: the tensors are children (copied into a
# program's buffers, so a new system's data replays the same graphs), the
# rest is static aux data (a callable by its identity: a new closure is a
# new program).

engine.register_node(
    LinearOperator,
    lambda op: ((), (op.matvec, op.matvec_cost_flops, op.matmat, op.rmatvec)),
    lambda aux, _: LinearOperator(*aux))
engine.register_node(DenseMatrixOperator, lambda op: ((op.mat,), ()),
                     lambda _, ch: DenseMatrixOperator(*ch))
engine.register_node(
    KernelSystemOperator,
    lambda op: ((op.sqrt_h,), (op.kernel_matvec, op.matvec_cost_flops)),
    lambda aux, ch: KernelSystemOperator(aux[0], ch[0], aux[1]))
engine.register_node(
    RBFKernelSystemOperator,
    lambda op: ((op.x, op.sqrt_h), (float(op.theta), float(op.lengthscale), op.block,
                                    op.backend)),
    lambda aux, ch: RBFKernelSystemOperator(*ch, *aux))
engine.register_node(LaneOperator, lambda op: ((op.ops,), ()), lambda _, ch: LaneOperator(*ch))
engine.register_node(LaneDenseOperator, lambda op: ((op.mats,), ()),
                     lambda _, ch: LaneDenseOperator(*ch))
