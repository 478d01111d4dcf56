"""The port's checkpoint manager (``repro_torch.checkpoint``).

Mirrors the four ``CheckpointManager`` tests of
``tests/test_checkpoint_runtime.py`` (roundtrip, retention and latest,
corrupt tail, structure mismatch); its trainer tests wait for the port's
``runtime/``.  The port writes the reference's on-disk layout
(``step_<n>/arrays.npz`` + ``manifest.json``, leaves named by their
path), so the roundtrip is also held across the two packages: each
restores what the other wrote.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import restore_pytree as j_restore  # noqa: E402
from repro.checkpoint import save_pytree as j_save  # noqa: E402
from repro_torch.checkpoint import (  # noqa: E402
    CheckpointManager,
    restore_pytree,
    save_pytree,
)
from repro_torch.checkpoint.manager import _leaves_with_names  # noqa: E402


def _tree():
    return {
        "a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
        "nested": {"b": torch.ones((4,), dtype=torch.bfloat16)},
        "scalar": torch.tensor(7, dtype=torch.int32),
    }


def _j_tree():
    return {
        "a": jnp.arange(6, dtype=jnp.float32).reshape(2, 3),
        "nested": {"b": jnp.ones((4,), jnp.bfloat16)},
        "scalar": jnp.int32(7),
    }


class TestCheckpoint:
    def test_roundtrip(self, tmp_path):
        tree = _tree()
        path = save_pytree(tree, str(tmp_path / "port"), step=3)
        out = restore_pytree(tree, path)
        for (name, a), b in zip(zip(*_leaves_with_names(tree)), _leaves_with_names(out)[1]):
            assert torch.equal(a, b), name
            assert a.dtype == b.dtype
        # The reference's layout, both ways.
        j_out = j_restore(_j_tree(), path)
        for name, a in zip(*_leaves_with_names(tree)):
            keys = name.strip("[]'").split("']['")
            got = j_out[keys[0]] if len(keys) == 1 else j_out[keys[0]][keys[1]]
            np.testing.assert_array_equal(np.asarray(got, dtype=np.float64),
                                          a.to(torch.float64).numpy())
        j_path = j_save(_j_tree(), str(tmp_path / "ref"), step=3)
        back = restore_pytree(tree, j_path)
        for a, b in zip(_leaves_with_names(tree)[1], _leaves_with_names(back)[1]):
            assert torch.equal(a, b) and a.dtype == b.dtype

    def test_manager_retention_and_latest(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep=2)
        template = {"x": torch.zeros(3, dtype=torch.float64)}
        for s in (1, 2, 3, 4):
            mgr.save({"x": torch.full((3,), float(s), dtype=torch.float64)}, s)
        assert mgr.steps() == [3, 4]
        assert mgr.last_deleted == [2] and mgr.deleted_total == 2
        step, out, _ = mgr.restore_latest(template)
        assert step == 4
        np.testing.assert_allclose(out["x"].numpy(), 4.0)

    def test_corrupt_tail_falls_back(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep=5)
        template = {"x": torch.zeros(3, dtype=torch.float64)}
        mgr.save({"x": torch.full((3,), 1.0, dtype=torch.float64)}, 1)
        mgr.save({"x": torch.full((3,), 2.0, dtype=torch.float64)}, 2)
        with open(os.path.join(str(tmp_path), "step_00000002", "arrays.npz"), "wb") as f:
            f.write(b"garbage")
        step, out, _ = mgr.restore_latest(template)
        assert step == 1
        np.testing.assert_allclose(out["x"].numpy(), 1.0)
        assert [s for s, _ in mgr.last_skipped] == [2]

    def test_structure_mismatch_rejected(self, tmp_path):
        path = save_pytree({"x": torch.zeros(3)}, str(tmp_path), step=1)
        with pytest.raises(ValueError):
            restore_pytree({"y": torch.zeros(3)}, path)
