"""Activation and parameter layouts: the port of ``repro.models.sharding``.

Model code annotates activations with *logical* dimension names
(``shard(x, "batch", None, "model")``); the launcher binds those names to
the axes of a ``torch.distributed`` :class:`DeviceMesh` with
:func:`set_axis_env` (``launch/mesh.py: bind``).  With no environment
bound, or on a plain tensor, an annotation returns its input: the same
model code runs on one device and on a mesh of ranks.  On a
:class:`~torch.distributed.tensor.DTensor` it redistributes to the bound
placements, which is where the reference's ``with_sharding_constraint``
lets GSPMD insert its collectives.

A layout is written as the reference's ``PartitionSpec``: a tuple with one
entry per tensor dim, each ``None``, a mesh axis name, or a tuple of them
(:func:`placements` turns it into DTensor placements, one per mesh dim).
Parameter layouts come from the reference's leaf-name suffixes:

  leaf-name suffix        spec (logical)          physical (default env)
  ----------------------  ----------------------  ----------------------
  ``*_cs`` (column)       (None, "model")         TP column-parallel
  ``*_rs`` (row)          ("model", None)         TP row-parallel
  ``*_es`` (expert)       ("model", None, None)   expert-parallel
  ``*_vs`` (vocab-major)  ("model", None)         vocab-sharded embedding
  ``*_hs`` (head-vector)  ("model",)              per-head vectors
  anything else           fully replicated

The port's parameter names are the reference's without the suffix
(``wq_cs`` → ``wq``); :data:`LEAF_SUFFIX`, :data:`SUB_SUFFIX` and
:data:`KV_SUFFIX` give each port name its suffix back (``convert`` carries
trees across with the same tables).  The reference stacks a period's
layers on a leading axis whose spec entry is ``None``; the port's layers
are modules of their own, so a port leaf's spec is the reference's
without that entry.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

Spec = Tuple[Any, ...]

# Logical name -> mesh axis (or tuple of axes), and the mesh; None: no-op.
_ENV: Optional[Dict[str, Any]] = None
_MESH = None

# The suffix of each port leaf name (``wk``/``wv``/``bk``/``bv`` take
# KV_SUFFIX where the KV heads are sharded, else none).  The MoE block's
# expert stacks share their port names with the MLP's leaves, so the
# suffix is looked up per sub-module.
LEAF_SUFFIX = {
    "wq": "_cs", "wo": "_rs", "bq": "_hs",
    "gate": "_cs", "up": "_cs", "down": "_rs", "up_bias": "_hs",
    "in_proj": "_cs", "conv_w": "_rs", "conv_b": "_hs", "a_log": "_hs",
    "dt_bias": "_hs", "d_skip": "_hs", "gate_norm": "_hs", "out_proj": "_rs",
    "table": "_vs", "lm_head": "_cs",
}
SUB_SUFFIX = {"moe": {"gate": "_es", "up": "_es", "down": "_es"}}
KV_SUFFIX = {"wk": "_cs", "wv": "_cs", "bk": "_hs", "bv": "_hs"}
ATTENTION_SUBS = ("attn", "cross_attn")

_SUFFIX_DIMS = {
    "_cs": (None, "model"),
    "_rs": ("model", None),
    "_es": ("model", None, None),
    "_vs": ("model", None),
    "_hs": ("model",),
}


def set_axis_env(env: Optional[Dict[str, Any]], mesh=None) -> None:
    """Bind logical dimension names to the axes of ``mesh`` (a
    ``DeviceMesh`` whose ``mesh_dim_names`` they name); ``None`` clears.

    The production binding (``launch/mesh.py``) is
    ``{"batch": ("pod", "data"), "model": "model", "seq": None,
    "fsdp": ("pod", "data")}``.
    """
    global _ENV, _MESH
    _ENV, _MESH = env, (mesh if env is not None else None)


def get_axis_env():
    return _ENV


def get_mesh():
    return _MESH


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def mesh_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def axis_size(name: str) -> int:
    """Product of the mesh-axis sizes bound to a logical name (1 if unbound)."""
    if _ENV is None or _MESH is None:
        return 1
    sizes = mesh_sizes(_MESH)
    out = 1
    for axis in _axes(_ENV.get(name)):
        out *= sizes[axis]
    return out


def logical_to_spec(dims: Sequence[Optional[str]]) -> Spec:
    """The physical spec of logical ``dims`` under the bound environment."""
    assert _ENV is not None
    return tuple(_ENV.get(d) if d else None for d in dims)


def placements(spec: Spec, axis_names: Sequence[str]) -> tuple:
    """DTensor placements (one per mesh axis of ``axis_names``) of a spec:
    an axis that shards tensor dim ``i`` is ``Shard(i)``, any other
    ``Replicate()``.  A tensor dim sharded over several axes is split in
    the order the spec names them (the reference's ``("pod", "data")``:
    pod-major), which is DTensor's order of mesh dims."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate()] * len(axis_names)
    for dim, entry in enumerate(spec):
        for axis in _axes(entry):
            out[list(axis_names).index(axis)] = Shard(dim)
    return tuple(out)


def spec_of(placements_: Sequence, axis_names: Sequence[str], ndim: int) -> Spec:
    """The inverse of :func:`placements`: a spec of ``ndim`` entries, each
    ``None``, one axis name or a tuple of them (in mesh order)."""
    dims = [[] for _ in range(ndim)]
    for axis, p in zip(axis_names, placements_):
        if p.is_shard():
            dims[p.dim].append(axis)
    return tuple(None if not d else d[0] if len(d) == 1 else tuple(d) for d in dims)


def is_distributed(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def shard(x: torch.Tensor, *dims: Optional[str]) -> torch.Tensor:
    """Constrain an activation's layout by logical dim names: ``x``
    redistributed to the bound placements when it is a DTensor and an
    environment is bound; ``x`` itself otherwise."""
    if _ENV is None or not is_distributed(x):
        return x
    want = placements(logical_to_spec(dims), x.device_mesh.mesh_dim_names)
    return x if tuple(x.placements) == want else x.redistribute(x.device_mesh, want)


def gathered(w: torch.Tensor) -> torch.Tensor:
    """A parameter with its ZeRO shards gathered: a DTensor redistributed
    to Replicate over the bound ``fsdp`` axes (its tensor-parallel dims
    kept), as the reference's SPMD partitioner gathers a layer's weights
    before use (and reduce-scatters their gradients: the backward of this
    redistribution); anything else as it is."""
    if _ENV is None or not is_distributed(w):
        return w
    from torch.distributed.tensor import Replicate

    fsdp = set(_axes(_ENV.get("fsdp")))
    want = tuple(Replicate() if name in fsdp else p
                 for name, p in zip(w.device_mesh.mesh_dim_names, w.placements))
    return w if tuple(w.placements) == want else w.redistribute(w.device_mesh, want)


_REPLICATING = 0  # the depth of nested plain_replicated blocks


@contextlib.contextmanager
def plain_replicated():
    """Within the block, under a bound environment, a plain tensor that
    meets a DTensor in an op counts as replicated (positions, masks, a
    step's scalars: the same on every rank).  The outermost block enters
    ``torch.distributed.tensor.experimental.implicit_replication`` once;
    the blocks inside it enter nothing (that context's exit turns the
    replication off, whoever entered it first)."""
    global _REPLICATING
    if _ENV is None or _REPLICATING:
        yield
        return
    from torch.distributed.tensor.experimental import implicit_replication

    _REPLICATING += 1
    try:
        with implicit_replication():
            yield
    finally:
        _REPLICATING -= 1


def on_mesh(fn):
    """``fn`` run under :func:`plain_replicated`."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with plain_replicated():
            return fn(*args, **kwargs)

    return wrapped


# ---------------------------------------------------------------------------
# Parameter specs from leaf-name suffixes
# ---------------------------------------------------------------------------


def leaf_suffix(name: str, sub: Optional[str] = None, kv: bool = False) -> str:
    """The reference's suffix of the port leaf ``name`` of sub-module
    ``sub`` (``attn``, ``mlp``, ``moe``, ...); ``kv``: the KV heads are
    sharded (:func:`repro_torch.models.attention.kv_sharded`)."""
    if kv and sub in ATTENTION_SUBS and name in KV_SUFFIX:
        return KV_SUFFIX[name]
    return SUB_SUFFIX.get(sub, LEAF_SUFFIX).get(name, "")


def leaf_dims(name: str, ndim: int, stacked: bool = False) -> Spec:
    """The logical spec of a reference leaf named ``name`` (suffix
    included) with ``ndim`` dims, ``stacked`` on a leading period axis."""
    dims: Tuple[Optional[str], ...] = ()
    for suffix, d in _SUFFIX_DIMS.items():
        if name.endswith(suffix):
            dims = d
            break
    pad = ndim - len(dims) - (1 if stacked else 0)
    full = ((None,) if stacked else ()) + (None,) * max(pad, 0) + dims
    return tuple(full[:ndim])


def spec_for_leaf(name: str, ndim: int, stacked: bool = False) -> Spec:
    """:func:`leaf_dims`: logical names under no environment, physical
    ones under the bound one."""
    full = leaf_dims(name, ndim, stacked)
    if _ENV is None:
        return full
    return tuple(_ENV.get(d) if d else None for d in full)


def ref_leaf_name(param_name: str, kv: bool = False) -> str:
    """The reference's leaf name (suffix included) of a port parameter
    name such as ``blocks.3.attn.wq``."""
    parts = param_name.split(".")
    sub = parts[-2] if len(parts) > 1 else None
    return parts[-1] + leaf_suffix(parts[-1], sub, kv)


def param_specs(model) -> Dict[str, Spec]:
    """``{parameter name: spec}`` of a :class:`~repro_torch.models.
    transformer.Model` (its KV suffixes from the model's ``tp``)."""
    from repro_torch.models.attention import kv_sharded

    kv = kv_sharded(model.cfg, model.tp)
    return {name: spec_for_leaf(ref_leaf_name(name, kv), p.dim())
            for name, p in model.named_parameters()}
