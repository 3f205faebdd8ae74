"""Data-layer tests: shuffle invariants and camera/ray statistics.

Modeled on the reference's (stale) ``test_dataset.py`` strategy — a fake
in-memory view driving ``iterate_batches`` with statistical assertions —
fixed to the current dataset API (SURVEY.md section 4).
"""

import os
import tempfile
from dataclasses import dataclass, field

import numpy as np

from learn_nerf_tpu.data import ModelMetadata, NeRFDataset, NeRFView


@dataclass
class DummyView(NeRFView):
    seed: int = 0
    shape: tuple = (12, 10)
    _img: np.ndarray = field(default=None, repr=False)

    def image(self) -> np.ndarray:
        if self._img is None:
            rng = np.random.RandomState(self.seed)
            self._img = rng.randint(0, 256, (*self.shape, 3), dtype=np.uint8)
        return self._img


def make_views(n):
    views = []
    rng = np.random.RandomState(123)
    for i in range(n):
        z = rng.randn(3)
        z /= np.linalg.norm(z)
        x = np.cross(z, [0.0, 0.0, 1.0])
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        views.append(
            DummyView(
                camera_direction=tuple(z),
                camera_origin=tuple(rng.randn(3) * 3),
                x_axis=tuple(x),
                y_axis=tuple(y),
                x_fov=1.0,
                y_fov=1.2,
                seed=i,
            )
        )
    return views


def test_iterate_batches_covers_all_rays_once():
    views = make_views(3)
    data = NeRFDataset(
        metadata=ModelMetadata(bbox_min=(-1, -1, -1), bbox_max=(1, 1, 1)),
        views=views,
    )
    total = sum(v.shape[0] * v.shape[1] for v in views)
    batch_size = 51
    with tempfile.TemporaryDirectory() as tmp:
        batches = list(
            data.iterate_batches(tmp, seed=0, batch_size=batch_size, repeat=False)
        )
    rows = np.concatenate(batches, axis=0)
    assert rows.shape == (total, 3, 3)
    assert all(b.shape[0] == batch_size for b in batches[:-1])

    # Per-view recovery by matching origins.
    for v in views:
        origin = np.asarray(v.camera_origin, np.float32)
        sel = np.all(np.abs(rows[:, 0] - origin) < 1e-5, axis=-1)
        assert sel.sum() == v.shape[0] * v.shape[1]
        # Mean direction approximately the camera direction.
        mean_dir = rows[sel, 1].mean(axis=0)
        mean_dir /= np.linalg.norm(mean_dir)
        assert np.dot(mean_dir, np.asarray(v.camera_direction)) > 0.99
        # Mean color matches the image under v/127.5-1.
        img_mean = v.image().reshape(-1, 3).astype(np.float32) / 127.5 - 1
        np.testing.assert_allclose(
            rows[sel, 2].mean(axis=0), img_mean.mean(axis=0), atol=1e-3
        )


def test_shuffle_cache_reused_and_repeat():
    views = make_views(2)
    data = NeRFDataset(
        metadata=ModelMetadata(bbox_min=(-1, -1, -1), bbox_max=(1, 1, 1)),
        views=views,
    )
    total = sum(v.shape[0] * v.shape[1] for v in views)
    with tempfile.TemporaryDirectory() as tmp:
        it1 = data.iterate_batches(tmp, seed=0, batch_size=32, repeat=False)
        first = np.concatenate(list(it1))
        assert os.path.exists(os.path.join(tmp, "done"))
        # Second pass must reuse the shards (poison the views to prove it).
        for v in views:
            v._img = np.zeros_like(v.image())
        it2 = data.iterate_batches(tmp, seed=0, batch_size=32, repeat=False)
        second = np.concatenate(list(it2))
        assert second.shape == first.shape
        assert not np.allclose(second[:, 2], -1.0)  # old colors, not poisoned

        # repeat=True keeps going past one epoch.
        it3 = data.iterate_batches(tmp, seed=1, batch_size=64, repeat=True)
        seen = 0
        for batch in it3:
            seen += batch.shape[0]
            if seen > 2 * total:
                break
        assert seen > 2 * total


def test_rays_are_normalized():
    view = make_views(1)[0]
    rays = view.bare_rays(9, 7)
    assert rays.shape == (63, 2, 3)
    np.testing.assert_allclose(
        np.linalg.norm(rays[:, 1], axis=-1), 1.0, rtol=1e-5
    )


def test_multihost_shuffle_disjoint_and_balanced():
    """Per-process shards cover every ray exactly once with pools equal
    to ±1 — ray-level striding, NOT view splits: with 5 views on 2 hosts
    a view split would give one host 1.5x the rays, and the equal
    per-step quota each host contributes would oversample the other
    host's views every batch."""
    from learn_nerf_tpu.data.shuffle import ShuffledDataset

    views = make_views(5)
    data = NeRFDataset(
        metadata=ModelMetadata(bbox_min=(-1, -1, -1), bbox_max=(1, 1, 1)),
        views=views,
    )
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        rows = {}
        for pid in range(2):
            with ShuffledDataset(
                tmp, data, seed=0, num_shards=4, process_id=pid, process_count=2
            ) as sd:
                rows[pid] = np.concatenate(list(sd.iterate_batches(16)))
        total = sum(v.shape[0] * v.shape[1] for v in views)
        assert rows[0].shape[0] + rows[1].shape[0] == total
        assert abs(rows[0].shape[0] - rows[1].shape[0]) <= 1  # balanced
        # Disjoint and complete at ray granularity.
        def keys(r):
            return {tuple(np.round(row.reshape(-1), 4)) for row in r}

        k0, k1 = keys(rows[0]), keys(rows[1])
        assert not (k0 & k1)
        # Every host sees rays from EVERY view (striding, not splitting).
        for pid in range(2):
            origins = {tuple(np.round(r, 4)) for r in rows[pid][:, 0]}
            expected = {
                tuple(np.round(np.asarray(v.camera_origin, np.float32), 4))
                for v in views
            }
            assert origins == expected


def test_prefetch_to_device_order_and_depth():
    """prefetch_to_device preserves order, applies place exactly once per
    item, and keeps `depth` placements dispatched ahead of consumption."""
    import pytest

    from learn_nerf_tpu.data.prefetch import prefetch_to_device

    placed = []

    def place(x):
        placed.append(x)
        return x * 10

    out = prefetch_to_device(range(5), place, depth=2)
    first = next(out)
    assert first == 0
    # Double buffering: items 0 and 1 were placed before 0 was yielded,
    # and pulling one more keeps exactly one extra in flight.
    assert placed == [0, 1]
    assert next(out) == 10
    assert placed == [0, 1, 2]
    assert list(out) == [20, 30, 40]
    assert placed == [0, 1, 2, 3, 4]

    assert list(prefetch_to_device([], place, depth=3)) == []
    assert list(prefetch_to_device([7], lambda x: x, depth=4)) == [7]
    with pytest.raises(ValueError):
        next(prefetch_to_device([1], lambda x: x, depth=0))


def test_multihost_shuffle_more_processes_than_views():
    """With more processes than views the partition switches to ray-level
    striding: every host still gets a nonempty, disjoint slice and the
    union covers every ray exactly once."""
    from learn_nerf_tpu.data.shuffle import ShuffledDataset

    views = make_views(2)
    data = NeRFDataset(
        metadata=ModelMetadata(bbox_min=(-1, -1, -1), bbox_max=(1, 1, 1)),
        views=views,
    )
    pcount = 3
    with tempfile.TemporaryDirectory() as tmp:
        rows = {}
        for pid in range(pcount):
            with ShuffledDataset(
                tmp, data, seed=0, num_shards=4,
                process_id=pid, process_count=pcount,
            ) as sd:
                rows[pid] = np.concatenate(list(sd.iterate_batches(16)))
        total = sum(v.shape[0] * v.shape[1] for v in views)
        assert all(rows[pid].shape[0] > 0 for pid in range(pcount))
        assert sum(rows[pid].shape[0] for pid in range(pcount)) == total
        # Disjoint + complete: every ray appears exactly once across hosts.
        all_rows = np.concatenate([rows[p] for p in range(pcount)])
        expected = np.concatenate(
            [np.asarray(v.rays(), np.float32) for v in views]
        )
        got = {r.tobytes() for r in all_rows}
        want = {r.tobytes() for r in expected}
        assert got == want


def test_shuffle_cache_invalidates_on_change():
    """The done marker stores a content signature: changing the view list
    or num_shards rebuilds the cache instead of serving stale rays."""
    from learn_nerf_tpu.data.shuffle import ShuffledDataset

    meta = ModelMetadata(bbox_min=(-1, -1, -1), bbox_max=(1, 1, 1))
    with tempfile.TemporaryDirectory() as tmp:
        data2 = NeRFDataset(metadata=meta, views=make_views(2))
        with ShuffledDataset(tmp, data2, seed=0, num_shards=4) as sd:
            n2 = np.concatenate(list(sd.iterate_batches(16))).shape[0]

        # Same directory, more views: cache must rebuild, not reuse.
        data3 = NeRFDataset(metadata=meta, views=make_views(3))
        with ShuffledDataset(tmp, data3, seed=0, num_shards=4) as sd:
            n3 = np.concatenate(list(sd.iterate_batches(16))).shape[0]
        assert n3 == sum(v.shape[0] * v.shape[1] for v in data3.views)
        assert n3 > n2

        # Changing num_shards also invalidates.
        with ShuffledDataset(tmp, data3, seed=0, num_shards=8) as sd:
            n8 = np.concatenate(list(sd.iterate_batches(16))).shape[0]
        assert n8 == n3

        # A legacy "done" marker (pre-signature cache) cannot be validated
        # against the current dataset: it REBUILDS rather than silently
        # serving possibly-stale shards.  The rebuilt
        # cache serves data2's rays even though the marked shards held
        # data3's.
        with open(os.path.join(tmp, "done"), "w") as f:
            f.write("done\n")
        with ShuffledDataset(tmp, data2, seed=0, num_shards=8) as sd:
            n_legacy = np.concatenate(list(sd.iterate_batches(16))).shape[0]
        assert n_legacy == n2

        # Same with shard files missing (cache built with fewer shards):
        # rebuilds instead of crashing on open.
        with open(os.path.join(tmp, "done"), "w") as f:
            f.write("done\n")
        with ShuffledDataset(tmp, data2, seed=0, num_shards=16) as sd:
            n_rebuilt = np.concatenate(list(sd.iterate_batches(16))).shape[0]
        assert n_rebuilt == n2


def test_shuffle_cache_invalidates_on_file_content_change():
    """The signature covers image size+mtime: a dataset regenerated IN
    PLACE under the same filenames rebuilds the cache instead of silently
    serving rays of the old images."""
    from learn_nerf_tpu.data.shuffle import _cache_signature

    class _View:
        def __init__(self, path):
            self.image_path = path

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "0000.png")
        with open(path, "wb") as f:
            f.write(b"old-bytes")
        views = [_View(path)]
        sig_old = _cache_signature(views, 4, 1)
        assert sig_old == _cache_signature(views, 4, 1)  # stable

        # Overwrite in place (different content AND size).
        with open(path, "wb") as f:
            f.write(b"regenerated-longer-bytes")
        assert _cache_signature(views, 4, 1) != sig_old

        # Same size, later mtime still invalidates.
        sig_mid = _cache_signature(views, 4, 1)
        os.utime(path, ns=(1, 10**15))
        assert _cache_signature(views, 4, 1) != sig_mid


def test_shuffle_cache_invalidates_on_pose_change():
    """The signature covers the camera parameters: pose refinement that
    rewrites only the *.json files (images untouched) must invalidate —
    shard rows bake ray origins/directions from the poses."""
    from learn_nerf_tpu.data.camera import CameraView
    from learn_nerf_tpu.data.shuffle import _cache_signature

    def view(origin):
        v = CameraView(
            camera_direction=(0.0, 0.0, 1.0),
            camera_origin=origin,
            x_axis=(1.0, 0.0, 0.0),
            y_axis=(0.0, 1.0, 0.0),
            x_fov=1.0,
            y_fov=1.0,
        )
        v.image_path = ""  # no image file; pose-only signature
        return v

    sig_a = _cache_signature([view((0.0, 0.0, -3.0))], 4, 1)
    assert sig_a == _cache_signature([view((0.0, 0.0, -3.0))], 4, 1)
    assert sig_a != _cache_signature([view((0.0, 0.1, -3.0))], 4, 1)


def test_stale_marker_removed_before_rebuild_truncates(tmp_path):
    """A rebuild must drop the old done marker BEFORE truncating shards:
    killed mid-rebuild with the old marker still on disk, a later run
    whose dataset matches the old signature would validate the marker
    over torn shard files and silently train on a fraction of the rays."""
    from learn_nerf_tpu.data.shuffle import ShuffledDataset

    views = make_views(2)
    data = NeRFDataset(
        metadata=ModelMetadata(bbox_min=(-1, -1, -1), bbox_max=(1, 1, 1)),
        views=views,
    )
    tmp = str(tmp_path)
    with ShuffledDataset(tmp, data, seed=0, num_shards=2) as sd:
        list(sd.iterate_batches(64))
    done = os.path.join(tmp, "done")
    assert os.path.exists(done)

    # Change the dataset (new view list) so the signature mismatches and
    # a rebuild starts — and make the rebuild die mid-way.
    data2 = NeRFDataset(metadata=data.metadata, views=make_views(3))
    import pytest

    from learn_nerf_tpu.data import shuffle as shuffle_mod

    def boom(self, *a, **k):
        # The marker must already be gone by the time shards are built.
        assert not os.path.exists(done)
        raise RuntimeError("killed mid-rebuild")

    orig = shuffle_mod.ShuffledDataset._create_shards
    shuffle_mod.ShuffledDataset._create_shards = boom
    try:
        with pytest.raises(RuntimeError):
            ShuffledDataset(tmp, data2, seed=0, num_shards=2)
    finally:
        shuffle_mod.ShuffledDataset._create_shards = orig
    # The torn cache must NOT validate for either dataset state.
    assert not os.path.exists(done)


def test_legacy_cache_always_rebuilds(tmp_path):
    """A pre-signature 'done' marker can never be validated against the
    current dataset, so it always rebuilds — even with an exactly-matching
    shard-file count."""
    import os

    from learn_nerf_tpu.data.shuffle import ShuffledDataset

    d = str(tmp_path)
    for i in range(4):
        with open(os.path.join(d, str(i)), "wb"):
            pass
    with open(os.path.join(d, "done"), "w") as f:
        f.write("done")
    # More shard files than this run wants: rebuild.
    assert not ShuffledDataset._cache_valid(
        os.path.join(d, "done"), "sig", [os.path.join(d, str(i)) for i in range(2)]
    )
    # Exact count: STILL a rebuild (contents unverifiable).
    os.remove(os.path.join(d, "2"))
    os.remove(os.path.join(d, "3"))
    assert not ShuffledDataset._cache_valid(
        os.path.join(d, "done"), "sig", [os.path.join(d, str(i)) for i in range(2)]
    )
    # A current signature-bearing marker is accepted.
    with open(os.path.join(d, "done"), "w") as f:
        f.write("sig\n")
    assert ShuffledDataset._cache_valid(
        os.path.join(d, "done"), "sig", [os.path.join(d, str(i)) for i in range(2)]
    )


def test_load_dataset_skips_extra_cameraless_png(tmp_path, capsys):
    """An innocuous extra PNG (preview, render output saved next to the
    data) loads with a loud warning, not a hard failure; a directory
    where EVERY png lacks its camera is still an error (the actual
    empty-iterator failure the check targets)."""
    import sys

    sys.path.insert(0, os.path.dirname(__file__))
    from synthetic_scene import write_dataset

    from learn_nerf_tpu.data.dataset import load_dataset

    d = str(tmp_path / "scene")
    write_dataset(d, num_views=2, resolution=8)
    from PIL import Image

    Image.fromarray(np.zeros((4, 4, 3), np.uint8)).save(
        os.path.join(d, "preview.png")
    )
    data = load_dataset(d)
    assert len(data.views) == 2
    out = capsys.readouterr().out
    assert "preview.png" in out and "warning" in out

    # Depth companions stay silently skipped (distillation datasets).
    Image.fromarray(np.zeros((4, 4, 3), np.uint8)).save(
        os.path.join(d, "0000_depth.png")
    )
    assert len(load_dataset(d).views) == 2

    # All-camera-less directory: error, not zero views.
    broken = str(tmp_path / "broken")
    os.makedirs(broken)
    import json as _json

    with open(os.path.join(broken, "metadata.json"), "w") as f:
        _json.dump(dict(min=[-1] * 3, max=[1] * 3), f)
    Image.fromarray(np.zeros((4, 4, 3), np.uint8)).save(
        os.path.join(broken, "0000.png")
    )
    import pytest

    with pytest.raises(FileNotFoundError, match="no usable views"):
        load_dataset(broken)
