"""Synthetic "infinite digits" generator — stand-in for infinite MNIST.

The paper's dataset (Loosli et al.'s infinite-MNIST 3-vs-5 task) is built
by applying random deformations to MNIST digits; MNIST itself is not
redistributable inside this offline container, so we generate the digits
procedurally: each class is a parametric stroke skeleton ("3" = two
right-bulging arcs, "5" = bar + stem + bowl), rasterized to 28×28 with a
Gaussian pen, under a random affine jitter (rotation/scale/shear/shift)
plus pixel noise — the same "infinite transformations of a prototype"
recipe, with the same binary-classification difficulty knobs.

Fully deterministic given the seed; pure numpy.  A copy of
``repro.data.digits`` (the port imports nothing of ``repro``), so both
packages draw the same samples from the same seed.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

IMG = 28


def _stroke_points_three(n_pts: int) -> np.ndarray:
    """Digit '3': two arcs bulging right, in unit coords (x right, y down)."""
    t1 = np.linspace(-0.5 * np.pi, 0.5 * np.pi, n_pts // 2)
    upper = np.stack(
        [0.42 + 0.18 * np.cos(t1), 0.32 + 0.14 * np.sin(t1)], axis=1
    )
    t2 = np.linspace(-0.5 * np.pi, 0.5 * np.pi, n_pts - n_pts // 2)
    lower = np.stack(
        [0.42 + 0.20 * np.cos(t2), 0.64 + 0.16 * np.sin(t2)], axis=1
    )
    return np.concatenate([upper, lower], axis=0)


def _stroke_points_five(n_pts: int) -> np.ndarray:
    """Digit '5': top bar, left stem, lower-right bowl."""
    n1, n2 = n_pts // 4, n_pts // 4
    n3 = n_pts - n1 - n2
    bar = np.stack(
        [np.linspace(0.30, 0.66, n1), np.full(n1, 0.20)], axis=1
    )
    stem = np.stack(
        [np.full(n2, 0.30), np.linspace(0.20, 0.46, n2)], axis=1
    )
    t = np.linspace(-0.75 * np.pi, 0.6 * np.pi, n3)
    bowl = np.stack(
        [0.42 + 0.20 * np.cos(t), 0.62 + 0.18 * np.sin(t)], axis=1
    )
    return np.concatenate([bar, stem, bowl], axis=0)


def _rasterize(points: np.ndarray, sigma: float = 0.95) -> np.ndarray:
    """Splat stroke points onto the 28×28 grid with a Gaussian pen."""
    px = points[:, 0] * IMG
    py = points[:, 1] * IMG
    gx = np.arange(IMG) + 0.5
    d2x = (gx[None, :] - px[:, None]) ** 2  # (m, 28)
    d2y = (gx[None, :] - py[:, None]) ** 2
    img = np.einsum(
        "my,mx->yx",
        np.exp(-0.5 * d2y / sigma**2),
        np.exp(-0.5 * d2x / sigma**2),
    )
    peak = img.max()
    return img / peak if peak > 0 else img


def make_infinite_digits(
    n: int,
    seed: int = 0,
    *,
    noise: float = 0.06,
    n_stroke_points: int = 120,
) -> Tuple[np.ndarray, np.ndarray]:
    """Generate n samples of the 3-vs-5 task.

    Returns:
      x: (n, 784) float32 in [0, 1]
      y: (n,) float32 in {−1, +1}   (+1 ≙ "3", −1 ≙ "5")
    """
    rng = np.random.default_rng(seed)
    protos = {
        +1: _stroke_points_three(n_stroke_points),
        -1: _stroke_points_five(n_stroke_points),
    }
    xs = np.empty((n, IMG * IMG), np.float32)
    ys = np.empty((n,), np.float32)
    labels = rng.permuted(np.repeat([1.0, -1.0], [n - n // 2, n // 2]))
    for i in range(n):
        label = labels[i]
        pts = protos[int(label)].copy()
        # Random affine jitter around the glyph center.
        ang = rng.uniform(-0.26, 0.26)  # ±15°
        scale = rng.uniform(0.85, 1.15)
        shear = rng.uniform(-0.15, 0.15)
        rot = np.array(
            [[np.cos(ang), -np.sin(ang)], [np.sin(ang), np.cos(ang)]]
        )
        shr = np.array([[1.0, shear], [0.0, 1.0]])
        center = np.array([0.45, 0.48])
        pts = (pts - center) @ (rot @ shr).T * scale + center
        pts += rng.uniform(-2.0 / IMG, 2.0 / IMG, size=2)

        img = _rasterize(pts)
        img += rng.normal(0.0, noise, img.shape)
        xs[i] = np.clip(img, 0.0, 1.0).ravel()
        ys[i] = label
    return xs, ys
