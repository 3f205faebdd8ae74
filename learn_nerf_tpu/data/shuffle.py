"""Two-stage out-of-core ray shuffle, generalized to multi-host.

Algorithm parity with the reference (``learn_nerf/dataset.py:162-263``,
the Jane Street two-stage shuffle): rays are first scattered at random into
``num_shards`` raw float32 files (reusable across runs via a ``done``
marker), then each epoch permutes the shard order and the rows within each
shard, concatenating remainders across shard boundaries.

Multi-host generalization (the reference is single-process): each process
writes its shards under ``host_{process_id}/`` and streams a disjoint ray
subset with no cross-host I/O — the per-host batches then join into one
globally-sharded array at the jit boundary
(``parallel.mesh.global_batch_from_local``).  The partition is RAY-level
striding (every process reads every view at build time but keeps rays
``process_id::process_count``): pools are equal to ±1 ray, so the equal
per-step quota each host contributes samples every ray uniformly.
Splitting whole views across hosts (the obvious alternative) gives
unequal pools whenever ``process_count`` does not divide the view list —
rays on ray-poor hosts would then be oversampled every step, and
``repeat=False`` streams would exhaust at different times per host.  The
cost is one full-dataset decode per host during the one-time cache
build.

The ``done`` marker stores a signature of (view list, num_shards,
process_count): a cache built for a different dataset layout invalidates
and rebuilds instead of silently serving stale rays (the reference shares
this flaw — its marker is unconditional, ``dataset.py:187-198``).
"""

import hashlib
import os
from typing import Iterator, Optional, Sequence

import numpy as np

ROW_SHAPE = (3, 3)
ROW_FLOATS = 9


def _cache_signature(
    views: Sequence, num_shards: int, process_count: int
) -> str:
    """Signature of everything that determines shard-file contents.

    Besides the layout (shard/process counts, view list), each image
    file's size and mtime enter the hash: a dataset regenerated *in
    place* under the same filenames (``make_blender_standin``-style
    ``exist_ok`` writers) must invalidate the cache — matching paths
    alone would silently serve rays of the old images.  The camera
    parameters enter too (shard rows bake ray origins/directions from
    them): pose refinement that rewrites only the ``*.json`` files must
    also invalidate, or training streams stale ray geometry.

    The SEED is deliberately NOT part of the signature: the scatter
    stage (ray->shard assignment) stays pinned to whichever seed built
    the cache, and only the within-shard/shard-order permutations follow
    the run's seed.  This is the documented workflow tradeoff (CLAUDE.md:
    pre-create the cache once — 92 s for 16M rays — and let every later
    run reuse it); the cost is that two seeded runs only replay the same
    batch stream when their cache state matches.  Delete ``shuffled/``
    for a fully seed-determined stream.
    """
    h = hashlib.md5()
    tag = f"v4:{num_shards}:{process_count}:"
    if process_count > 1:
        # Multi-host caches built before ray-striding became the only
        # partition (view-level splits gave unequal pools) must rebuild;
        # single-host signatures stay byte-identical (their contents are
        # unchanged, and the 92 s compound-scene cache stays valid).
        tag += "ray-stride:"
    h.update(f"{tag}{len(views)}".encode())
    for view in views:
        path = str(getattr(view, "image_path", ""))
        h.update(path.encode())
        if path:
            try:
                st = os.stat(path)
                h.update(f":{st.st_size}:{st.st_mtime_ns}".encode())
            except OSError:
                pass
        camera = getattr(view, "to_json", None)
        if camera is not None:
            h.update(camera().encode())
        h.update(b"\x00")
    return h.hexdigest()


class ShuffledDataset:
    def __init__(
        self,
        dir_path: str,
        dataset,
        seed: int,
        num_shards: int = 32,
        process_id: Optional[int] = None,
        process_count: Optional[int] = None,
    ):
        if process_id is None or process_count is None:
            # Both or neither: a caller passing only process_id would
            # otherwise crash on max(None, 1) below, and mixing an
            # explicit id with an auto-detected count is never right.
            try:
                import jax

                process_id = jax.process_index()
                process_count = jax.process_count()
            except Exception:
                process_id, process_count = 0, 1
        process_count = max(process_count, 1)
        self.num_shards = num_shards
        rng = np.random.Generator(np.random.Philox(seed))
        self._shard_rng, self._shuffle_rng = rng.spawn(2)

        host_dir = (
            os.path.join(dir_path, f"host_{process_id}")
            if process_count > 1
            else dir_path
        )
        os.makedirs(host_dir, exist_ok=True)
        done_path = os.path.join(host_dir, "done")
        paths = [os.path.join(host_dir, str(i)) for i in range(num_shards)]
        signature = _cache_signature(dataset.views, num_shards, process_count)
        if self._cache_valid(done_path, signature, paths):
            self.fds = [open(p, "rb") for p in paths]
        else:
            # Drop any stale marker BEFORE truncating the shard files: a
            # rebuild killed mid-way must not leave an old signature that
            # re-validates over torn shards if the dataset is later
            # restored to the state the marker describes.
            if os.path.exists(done_path):
                os.remove(done_path)
            self.fds = [open(p, "wb+") for p in paths]
            if process_count > 1:
                # Ray-level striding: every view, rays pid::pcount each
                # (equal pools ±1; see the module docstring for why
                # view-level splits are wrong).
                self._create_shards(
                    dataset.views, ray_stride=(process_id, process_count)
                )
            else:
                self._create_shards(dataset.views)
            # Flush + fsync every shard BEFORE the done marker: the fds
            # stay open for the whole run, and a killed process (wedged
            # chip, manual kill mid-compile — routine in this workflow)
            # between the marker write and the first epoch would leave a
            # signature-valid marker over truncated shard tails.
            for fd in self.fds:
                fd.flush()
                os.fsync(fd.fileno())
            with open(done_path, "w") as f:
                f.write(signature + "\n")
                f.flush()
                os.fsync(f.fileno())

    @staticmethod
    def _cache_valid(
        done_path: str, signature: str, paths: Sequence[str]
    ) -> bool:
        if not os.path.exists(done_path):
            return False
        if not all(os.path.exists(p) for p in paths):
            # A marker whose shard files are missing (e.g. a cache built
            # with a smaller num_shards) must rebuild, not crash later
            # with FileNotFoundError on shard open.
            return False
        with open(done_path) as f:
            content = f.read().strip()
        if content == "done":
            # Pre-signature cache (or one written by the reference): its
            # contents CANNOT be validated against the current dataset, so
            # rebuild instead of trusting it — the one remaining silent-
            # staleness path in a layer that otherwise content-signs
            # everything.  A rebuild costs one shuffle pass; serving a
            # stale cache costs a silently-wrong training run.
            print(
                f"note: shuffle cache {done_path} predates content "
                "signatures and cannot be validated; rebuilding",
                flush=True,
            )
            return False
        return content == signature

    def __enter__(self):
        return self

    def __exit__(self, *args):
        self.close()

    def close(self):
        for fd in self.fds:
            fd.close()

    def iterate_batches(
        self, batch_size: int, repeat: bool = False
    ) -> Iterator[np.ndarray]:
        """Yield shuffled ``[batch_size, 3, 3]`` batches.

        With ``repeat=False`` the final batch may be short; with
        ``repeat=True`` the stream re-permutes every epoch forever.
        """
        rng = self._shuffle_rng
        carry = None
        while True:
            for shard in rng.permutation(self.num_shards):
                rows = self._read_shard(int(shard))
                rows = rows[rng.permutation(rows.shape[0])]
                carry = rows if carry is None else np.concatenate([carry, rows])
                while carry.shape[0] >= batch_size:
                    yield carry[:batch_size]
                    carry = carry[batch_size:]
            if not repeat:
                break
        if carry is not None and carry.shape[0]:
            yield carry

    def _create_shards(self, views, ray_stride=None) -> None:
        for view in views:
            rays = np.asarray(view.rays(), dtype=np.float32)
            if ray_stride is not None:
                pid, pcount = ray_stride
                rays = rays[pid::pcount]
            assignments = self._shard_rng.integers(0, self.num_shards, rays.shape[0])
            order = np.argsort(assignments, kind="stable")
            sorted_rays = rays[order]
            counts = np.bincount(assignments, minlength=self.num_shards)
            offset = 0
            for shard, count in enumerate(counts):
                if count:
                    self.fds[shard].write(sorted_rays[offset : offset + count].tobytes())
                offset += count

    def _read_shard(self, shard: int) -> np.ndarray:
        f = self.fds[shard]
        f.seek(0)
        data = f.read()
        # No .copy(): the only caller fancy-indexes the result, which
        # allocates a fresh array anyway; copying here just raises peak
        # transient memory to ~3x shard size.
        return np.frombuffer(data, dtype=np.float32).reshape(-1, *ROW_SHAPE)
