"""Generate a tiny synthetic PNG+JSON dataset for end-to-end tests.

A unit cube at the origin rendered by ray/box intersection: pixels whose
rays hit the box get a face-dependent color, the rest are background.  Just
enough structure for a NeRF to overfit in a few hundred steps.
"""

import json
import os

import numpy as np
from PIL import Image

from learn_nerf_tpu.data.camera import CameraView


def cube_color(origins, dirs, half=0.5):
    """Color rays by the cube face they first hit (or black background)."""
    bmin, bmax = -half, half
    with np.errstate(divide="ignore", invalid="ignore"):
        t0 = (bmin - origins) / dirs
        t1 = (bmax - origins) / dirs
    near = np.minimum(t0, t1)
    far = np.maximum(t0, t1)
    t_enter = np.maximum(near.max(axis=-1), 0.0)
    t_exit = far.min(axis=-1)
    hit = t_enter < t_exit

    pts = origins + dirs * t_enter[:, None]
    axis = np.argmax(np.abs(pts), axis=-1)
    sign = np.take_along_axis(pts, axis[:, None], axis=-1)[:, 0] > 0
    palette = np.array(
        [
            [255, 60, 60],
            [60, 255, 60],
            [60, 60, 255],
            [255, 255, 60],
            [60, 255, 255],
            [255, 60, 255],
        ],
        dtype=np.uint8,
    )
    colors = palette[axis * 2 + sign.astype(int)]
    colors[~hit] = 0
    return colors


def orbit_views(n, distance=2.0, fov=1.0, phase=0.0):
    views = []
    for i in range(n):
        theta = 2 * np.pi * i / n + phase
        phi = 0.3 * np.sin(3 * theta)
        z = -np.array(
            [np.cos(theta) * np.cos(phi), np.sin(theta) * np.cos(phi), np.sin(phi)]
        )
        x = np.cross(z, [0.0, 0.0, 1.0])
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        views.append(
            CameraView(
                camera_direction=tuple(z.tolist()),
                camera_origin=tuple((-z * distance).tolist()),
                x_axis=tuple(x.tolist()),
                y_axis=tuple(y.tolist()),
                x_fov=fov,
                y_fov=fov,
            )
        )
    return views


def write_dataset(out_dir, num_views=8, resolution=24, seed=None):
    """Write the cube scene; ``seed`` rotates the orbit's starting angle
    (None keeps the fixed orbit)."""
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "metadata.json"), "w") as f:
        json.dump(dict(min=[-0.7] * 3, max=[0.7] * 3), f)
    phase = 0.0
    if seed is not None:
        phase = np.random.RandomState(seed).uniform(0.0, 2 * np.pi / num_views)
    for i, view in enumerate(orbit_views(num_views, phase=phase)):
        rays = view.bare_rays(resolution, resolution)
        colors = cube_color(rays[:, 0], rays[:, 1])
        img = colors.reshape(resolution, resolution, 3)
        Image.fromarray(img).save(os.path.join(out_dir, f"{i:04}.png"))
        with open(os.path.join(out_dir, f"{i:04}.json"), "w") as f:
            f.write(view.to_json())
    return out_dir
