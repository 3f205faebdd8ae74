"""Generate a synthetic forward-facing capture in LLFF format.

No real LLFF capture is available offline, so this builds one (a
stand-in for forward-facing scenes): a handheld-style grid of cameras at z ~ -2.2 looking at
the colored unit cube of tests/synthetic_scene, stored EXACTLY as LLFF
expects it — ``poses_bounds.npy`` ([N,17], bmild/nerf pose convention) plus
``images/*.png`` — so ``convert/llff.py`` runs unmodified on it.

Usage: python tools/make_llff_standin.py runs/llff_capture [resolution]
"""

import os
import sys

import numpy as np
from PIL import Image

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from learn_nerf_tpu.data.camera import CameraView  # noqa: E402
from tests.synthetic_scene import cube_color  # noqa: E402


def llff_row(x, y, z, origin, height, width, focal, near, far):
    """Encode our camera axes into a bmild/nerf poses_bounds row.

    convert/llff.py decodes ``x <- col1, y <- col0, z <- -col2``; invert
    that here so the round trip reproduces the intended camera.
    """
    cols = np.stack(
        [np.asarray(y), np.asarray(x), -np.asarray(z), np.asarray(origin),
         np.asarray([height, width, focal])],
        axis=1,
    )
    return np.concatenate([cols.reshape(15), [near, far]])


def main():
    out_dir = sys.argv[1] if len(sys.argv) > 1 else "runs/llff_capture"
    res = int(sys.argv[2]) if len(sys.argv) > 2 else 64
    img_dir = os.path.join(out_dir, "images")
    os.makedirs(img_dir, exist_ok=True)

    focal = res * 1.1  # ~49 degree x_fov
    dist = 2.2
    rows = []
    idx = 0
    for dy in (-0.35, 0.0, 0.35):
        for dx in (-0.45, -0.15, 0.15, 0.45):
            origin = np.array([dx, dy, -dist])
            z = -origin / np.linalg.norm(origin)  # look at the cube center
            x = np.cross(np.array([0.0, 1.0, 0.0]), z)
            x /= np.linalg.norm(x)
            y = np.cross(z, x)
            rows.append(
                llff_row(x, y, z, origin, res, res, focal, dist - 1.0, dist + 1.0)
            )

            view = CameraView(
                camera_direction=tuple(z.tolist()),
                camera_origin=tuple(origin.tolist()),
                x_axis=tuple(x.tolist()),
                y_axis=tuple(y.tolist()),
                x_fov=float(2 * np.arctan2(res, 2 * focal)),
                y_fov=float(2 * np.arctan2(res, 2 * focal)),
            )
            rays = view.bare_rays(res, res)
            img = cube_color(rays[:, 0], rays[:, 1]).reshape(res, res, 3)
            Image.fromarray(img).save(os.path.join(img_dir, f"{idx:05}.png"))
            idx += 1

    np.save(os.path.join(out_dir, "poses_bounds.npy"), np.stack(rows))
    print(f"wrote {idx} views to {out_dir}")


if __name__ == "__main__":
    main()
