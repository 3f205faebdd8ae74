"""Generate a synthetic capture in the original-NeRF Blender format.

No real Blender-synthetic scene (lego etc.) is available offline, so this
builds one: orbit cameras around the colored unit cube of
tests/synthetic_scene, stored EXACTLY as the original NeRF repo stores it
— ``transforms_{split}.json`` with OpenGL-convention ``transform_matrix``
rows (camera x right, y up, z backward) plus ``{split}/r_i.png`` — so
both ``convert/blender.py`` (ours) and the reference's
``convert_dataset/blender.py`` run unmodified on it.

The transform matrix is built by INVERTING the converter's decode
(x = R @ [1,0,0], y = R @ [0,-1,0], z = R @ [0,0,-1],
``convert_dataset/blender.py:36-42``): R's columns are (x, -y, -z) of the
view used to render the image, so a converted dataset reproduces the
render cameras bit-for-bit — verified by tests/test_convert.py.

Usage: python tools/make_blender_standin.py out_dir [resolution] [n_views]
"""

import json
import os
import sys

import numpy as np
from PIL import Image

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tests.synthetic_scene import cube_color, orbit_views  # noqa: E402


def main():
    out_dir = sys.argv[1] if len(sys.argv) > 1 else "runs/blender_capture"
    res = int(sys.argv[2]) if len(sys.argv) > 2 else 64
    n_views = int(sys.argv[3]) if len(sys.argv) > 3 else 24
    fov = 0.9

    for split, views in (
        ("train", orbit_views(n_views, fov=fov)),
        ("test", orbit_views(7, distance=2.3, fov=fov)),
    ):
        os.makedirs(os.path.join(out_dir, split), exist_ok=True)
        frames = []
        for i, view in enumerate(views):
            rays = view.bare_rays(res, res)
            img = cube_color(rays[:, 0], rays[:, 1]).reshape(res, res, 3)
            Image.fromarray(img).save(
                os.path.join(out_dir, split, f"r_{i}.png")
            )
            mat = np.eye(4)
            mat[:3, 0] = view.x_axis
            mat[:3, 1] = -np.asarray(view.y_axis)
            mat[:3, 2] = -np.asarray(view.camera_direction)
            mat[:3, 3] = view.camera_origin
            frames.append(
                dict(file_path=f"./{split}/r_{i}", transform_matrix=mat.tolist())
            )
        with open(os.path.join(out_dir, f"transforms_{split}.json"), "w") as f:
            json.dump(dict(camera_angle_x=fov, frames=frames), f)
    print(f"wrote Blender-format capture: {out_dir} ({res}x{res})")


if __name__ == "__main__":
    main()
