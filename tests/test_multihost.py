"""Real 2-process multi-host integration test (SURVEY.md section 2.5).

Spawns two JAX processes on localhost (CPU platform, 2 virtual devices
each -> a 4-device global mesh), each loading its own per-host view shards
and contributing local batch rows via
``make_array_from_process_local_data``; the jitted data-parallel step
all-reduces gradients across processes through gloo collectives.  Verifies
both processes exit cleanly, stream disjoint ray subsets, and agree on the
(replicated) training metrics.
"""

import os
import re
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_data_parallel_training(tmp_path):
    from tests.synthetic_scene import write_dataset

    data_dir = str(tmp_path / "data")
    write_dataset(data_dir, num_views=6, resolution=16)

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")

    port = _free_port()
    worker = os.path.join(REPO, "tests", "multihost_worker.py")
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(pid), str(port), data_dir],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        for pid in (0, 1)
    ]
    outs = [p.communicate(timeout=540)[0] for p in procs]
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {pid} failed:\n{out[-3000:]}"

    # Replicated metrics must agree bit-for-bit across processes — for the
    # hierarchy loop and for the occupancy loop's dense + pooled steps.
    for tag in ("METRICS", "OCC_METRICS"):
        metrics = [
            re.search(rf"{tag} (\{{.*\}})", out).group(1) for out in outs
        ]
        assert metrics[0] == metrics[1], f"{tag}: {metrics[0]} != {metrics[1]}"

    # Each host sharded a disjoint half of the views: 3 views x 16x16 rays.
    rows = [
        int(re.search(r"local_rows=(\d+)", out).group(1)) for out in outs
    ]
    assert rows == [3 * 16 * 16, 3 * 16 * 16], rows

    # The two hosts' shard files live in separate host_N directories.
    shuffled = tmp_path / "data" / "shuffled"
    assert (shuffled / "host_0" / "done").exists()
    assert (shuffled / "host_1" / "done").exists()
