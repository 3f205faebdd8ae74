"""Dataset converter tests (Blender-synthetic and LLFF)."""

import json
import os

import numpy as np
from PIL import Image


def test_blender_converter(tmp_path):
    from learn_nerf_tpu.convert import blender

    src = tmp_path / "blender"
    os.makedirs(src / "train")
    # Identity pose at origin looking down -z (OpenGL convention).
    frames = []
    for i, angle in enumerate([0.0, np.pi / 2]):
        c, s = np.cos(angle), np.sin(angle)
        rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        mat = np.eye(4)
        mat[:3, :3] = rot
        mat[:3, 3] = [i, 0.0, 4.0]
        frames.append(
            dict(file_path=f"./train/r_{i}", transform_matrix=mat.tolist())
        )
        Image.fromarray(
            np.full((20, 30, 3), 50 * (i + 1), np.uint8)
        ).save(src / "train" / f"r_{i}.png")
    with open(src / "transforms_train.json", "w") as f:
        json.dump(dict(camera_angle_x=0.7, frames=frames), f)

    out = str(tmp_path / "out")
    blender.main(["--split", "train", str(src), out])

    meta = json.load(open(os.path.join(out, "metadata.json")))
    assert meta == dict(min=[-1.0] * 3, max=[1.0] * 3)
    info = json.load(open(os.path.join(out, "0000.json")))
    assert info["origin"] == [0.0, 0.0, 4.0]
    np.testing.assert_allclose(info["x"], [1, 0, 0], atol=1e-9)
    np.testing.assert_allclose(info["y"], [0, -1, 0], atol=1e-9)
    np.testing.assert_allclose(info["z"], [0, 0, -1], atol=1e-9)
    assert abs(info["x_fov"] - 0.7) < 1e-9
    # y_fov from aspect 20/30.
    expected_y = 2 * np.arctan(np.tan(0.35) * 20 / 30)
    assert abs(info["y_fov"] - expected_y) < 1e-9
    assert os.path.exists(os.path.join(out, "0001.png"))

    # Loadable by our dataset layer.
    from learn_nerf_tpu.data import load_dataset

    data = load_dataset(out)
    assert len(data.views) == 2


def test_llff_converter(tmp_path):
    from learn_nerf_tpu.convert import llff

    src = tmp_path / "llff"
    os.makedirs(src / "images")
    n = 3
    poses = np.zeros((n, 17))
    for i in range(n):
        # Columns: x, y, z, pos, hwf.
        info = np.stack(
            [
                [0, 1, 0],  # x
                [-1, 0, 0],  # y
                [0, 0, 1],  # z
                [i, 0.0, 2.0],  # pos
                [40, 60, 50.0],  # hwf
            ],
            axis=1,
        )
        poses[i, :15] = info.reshape(-1)
        poses[i, 15:] = [0.5, 3.0]
        Image.fromarray(np.full((40, 60, 3), 20 * i, np.uint8)).save(
            src / "images" / f"img_{i}.png"
        )
    np.save(src / "poses_bounds.npy", poses)

    out = str(tmp_path / "out_llff")
    llff.main([str(src), out])

    meta = json.load(open(os.path.join(out, "metadata.json")))
    # bbox = union of pos +- z_far.
    np.testing.assert_allclose(meta["min"], [-3.0, -3.0, -1.0])
    np.testing.assert_allclose(meta["max"], [5.0, 3.0, 5.0])

    info = json.load(open(os.path.join(out, "00000.json")))
    # x,y,z = (y,-x,z) then y,z negated: y = -(-x_in) = x_in.
    np.testing.assert_allclose(info["x"], [-1, 0, 0], atol=1e-9)
    np.testing.assert_allclose(info["y"], [0, 1, 0], atol=1e-9)
    np.testing.assert_allclose(info["z"], [0, 0, -1], atol=1e-9)
    assert abs(info["x_fov"] - 2 * np.arctan(60 / (2 * 50))) < 1e-9
    assert abs(info["y_fov"] - 2 * np.arctan(40 / (2 * 50))) < 1e-9

    from learn_nerf_tpu.data import load_dataset

    data = load_dataset(out)
    assert len(data.views) == 3


def test_llff_downscale(tmp_path):
    from learn_nerf_tpu.convert import llff

    src = tmp_path / "llff2"
    os.makedirs(src / "images")
    poses = np.zeros((1, 17))
    info = np.stack(
        [[0, 1, 0], [-1, 0, 0], [0, 0, 1], [0, 0, 2.0], [40, 60, 50.0]], axis=1
    )
    poses[0, :15] = info.reshape(-1)
    poses[0, 15:] = [0.5, 3.0]
    np.save(src / "poses_bounds.npy", poses)
    Image.fromarray(np.zeros((40, 60, 3), np.uint8)).save(src / "images" / "a.png")

    out = str(tmp_path / "out2")
    llff.main(["--factor", "0.5", str(src), out])
    img = Image.open(os.path.join(out, "00000.png"))
    assert img.size == (30, 20)


def test_llff_standin_capture_roundtrip(tmp_path):
    """Full LLFF pipeline: synthetic forward-facing capture in genuine LLFF
    format -> convert/llff.py -> dataset whose cameras reproduce the ground
    truth exactly (stand-in for a real LLFF capture)."""
    import subprocess
    import sys

    import numpy as np

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cap, out = str(tmp_path / "cap"), str(tmp_path / "data")
    subprocess.run(
        [sys.executable, os.path.join(repo, "tools/make_llff_standin.py"), cap, "32"],
        check=True,
        capture_output=True,
        env=dict(
            os.environ,
            # Append, don't override the inherited PYTHONPATH.
            PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""),
        ),
    )
    from learn_nerf_tpu.convert import llff

    llff.main([cap, out])

    from learn_nerf_tpu.data.dataset import load_dataset
    from tests.synthetic_scene import cube_color

    data = load_dataset(out)
    assert len(data.views) == 12
    # Forward-facing loose bbox covers the cube.
    assert all(m <= -0.5 for m in data.metadata.bbox_min)
    assert all(m >= 0.5 for m in data.metadata.bbox_max)
    for view in data.views[:3]:
        rays = view.bare_rays(32, 32)
        expect = cube_color(rays[:, 0], rays[:, 1]).reshape(32, 32, 3)
        np.testing.assert_array_equal(view.image(), expect)


def test_blender_standin_capture_roundtrip(tmp_path):
    """Blender-protocol stand-in -> convert/blender.py -> dataset whose
    cameras reproduce the ground-truth renders exactly (the Blender
    counterpart of the LLFF round trip above)."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cap, out = str(tmp_path / "cap"), str(tmp_path / "data")
    subprocess.run(
        [
            sys.executable,
            os.path.join(repo, "tools/make_blender_standin.py"),
            cap, "32", "6",
        ],
        check=True,
        capture_output=True,
        env=dict(
            os.environ,
            PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""),
        ),
    )
    from learn_nerf_tpu.convert import blender

    blender.main(["--split", "train", cap, out])

    from learn_nerf_tpu.data.dataset import load_dataset
    from tests.synthetic_scene import cube_color

    data = load_dataset(out)
    assert len(data.views) == 6
    for view in data.views[:3]:
        rays = view.bare_rays(32, 32)
        expect = cube_color(rays[:, 0], rays[:, 1]).reshape(32, 32, 3)
        np.testing.assert_array_equal(view.image(), expect)


REFERENCE_CONVERTERS = "/root/reference/convert_dataset"


def _run_reference_converter(script, argv):
    """Execute the reference's converter script in a subprocess (its own
    argparse main; numpy+PIL only — no learn_nerf import)."""
    import subprocess
    import sys

    subprocess.run(
        [sys.executable, os.path.join(REFERENCE_CONVERTERS, script), *argv],
        check=True,
        capture_output=True,
    )


def _assert_same_frame_jsons(ref_dir, our_dir):
    ref_files = sorted(f for f in os.listdir(ref_dir) if f.endswith(".json"))
    our_files = sorted(f for f in os.listdir(our_dir) if f.endswith(".json"))
    assert ref_files == our_files and len(ref_files) >= 3
    for name in ref_files:
        ref = json.load(open(os.path.join(ref_dir, name)))
        ours = json.load(open(os.path.join(our_dir, name)))
        assert set(ref) == set(ours), name
        for key in ref:
            np.testing.assert_allclose(
                np.asarray(ours[key], np.float64),
                np.asarray(ref[key], np.float64),
                rtol=1e-12,
                atol=1e-12,
                err_msg=f"{name}:{key}",
            )


def _random_rotation(rng):
    """Uniform-ish proper rotation via QR (det fixed to +1)."""
    q, r = np.linalg.qr(rng.randn(3, 3))
    q *= np.sign(np.diag(r))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    return q


def test_blender_converter_matches_reference(tmp_path):
    """Run the REFERENCE blender converter and ours on the same
    transforms_train.json capture (non-trivial rotations) and assert
    identical per-frame JSONs and metadata."""
    import pytest

    if not os.path.isdir(REFERENCE_CONVERTERS):
        pytest.skip("reference tree not available")

    src = tmp_path / "blender"
    os.makedirs(src / "train")
    rng = np.random.RandomState(11)
    frames = []
    for i in range(4):
        mat = np.eye(4)
        mat[:3, :3] = _random_rotation(rng)
        mat[:3, 3] = rng.randn(3) * 2.0
        frames.append(
            dict(file_path=f"./train/r_{i}", transform_matrix=mat.tolist())
        )
        Image.fromarray(
            rng.randint(0, 256, (24, 36, 3), dtype=np.uint8)
        ).save(src / "train" / f"r_{i}.png")
    with open(src / "transforms_train.json", "w") as f:
        json.dump(dict(camera_angle_x=0.6911112070083618, frames=frames), f)

    ref_out = str(tmp_path / "out_ref")
    our_out = str(tmp_path / "out_ours")
    _run_reference_converter(
        "blender.py", ["--split", "train", str(src), ref_out]
    )
    from learn_nerf_tpu.convert import blender

    blender.main(["--split", "train", str(src), our_out])

    _assert_same_frame_jsons(ref_out, our_out)
    ref_meta = json.load(open(os.path.join(ref_out, "metadata.json")))
    our_meta = json.load(open(os.path.join(our_out, "metadata.json")))
    assert ref_meta == our_meta
    # Images copied identically.
    ref_img = np.asarray(Image.open(os.path.join(ref_out, "0002.png")))
    our_img = np.asarray(Image.open(os.path.join(our_out, "0002.png")))
    np.testing.assert_array_equal(ref_img, our_img)


def test_llff_converter_matches_reference(tmp_path):
    """Reference llff.py vs ours on the same genuine-format
    poses_bounds.npy capture (the LLFF stand-in): identical per-frame
    JSONs, metadata bbox, and image sizes, at factor 1 and downscaled."""
    import subprocess
    import sys

    import pytest

    if not os.path.isdir(REFERENCE_CONVERTERS):
        pytest.skip("reference tree not available")

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cap = str(tmp_path / "cap")
    subprocess.run(
        [sys.executable, os.path.join(repo, "tools/make_llff_standin.py"), cap, "40"],
        check=True,
        capture_output=True,
        env=dict(
            os.environ,
            PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""),
        ),
    )

    from learn_nerf_tpu.convert import llff

    for factor in (1.0, 0.5):
        ref_out = str(tmp_path / f"out_ref_{factor}")
        our_out = str(tmp_path / f"out_ours_{factor}")
        _run_reference_converter(
            "llff.py", ["--factor", str(factor), cap, ref_out]
        )
        llff.main(["--factor", str(factor), cap, our_out])
        _assert_same_frame_jsons(ref_out, our_out)
        ref_meta = json.load(open(os.path.join(ref_out, "metadata.json")))
        our_meta = json.load(open(os.path.join(our_out, "metadata.json")))
        np.testing.assert_allclose(ref_meta["min"], our_meta["min"], rtol=1e-12)
        np.testing.assert_allclose(ref_meta["max"], our_meta["max"], rtol=1e-12)
        ref_img = Image.open(os.path.join(ref_out, "00001.png"))
        our_img = Image.open(os.path.join(our_out, "00001.png"))
        assert ref_img.size == our_img.size
        np.testing.assert_array_equal(np.asarray(ref_img), np.asarray(our_img))
