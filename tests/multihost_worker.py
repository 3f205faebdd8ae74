"""Worker for the 2-process multi-host integration test.

Run as: python multihost_worker.py <process_id> <port> <data_dir>
with JAX_PLATFORMS=cpu and XLA_FLAGS=--xla_force_host_platform_device_count=2
set in the environment before interpreter start.

Each process owns half the views (per-host shard files), contributes its
local batch rows through ``make_array_from_process_local_data``, and runs
two real data-parallel training steps over the 4-device global mesh with
cross-process gradient all-reduce (gloo).  Prints a final metrics line the
parent compares across processes.
"""

import sys


def main():
    process_id, port, data_dir = int(sys.argv[1]), sys.argv[2], sys.argv[3]

    import jax

    try:
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    except Exception:
        pass
    jax.distributed.initialize(
        f"localhost:{port}", num_processes=2, process_id=process_id
    )
    assert jax.process_count() == 2, jax.process_count()
    assert len(jax.devices()) == 4, jax.devices()
    assert len(jax.local_devices()) == 2

    import numpy as np

    from learn_nerf_tpu.data.dataset import load_dataset
    from learn_nerf_tpu.data.shuffle import ShuffledDataset
    from learn_nerf_tpu.models import NeRFModel
    from learn_nerf_tpu.parallel.mesh import default_mesh
    from learn_nerf_tpu.train import TrainLoop

    data = load_dataset(data_dir)
    mesh = default_mesh()

    model_kwargs = dict(
        hidden_dim=16, color_layer_dim=8, input_layers=1, mid_layers=1
    )
    loop = TrainLoop(
        NeRFModel(**model_kwargs),
        NeRFModel(**model_kwargs),
        init_rng=jax.random.PRNGKey(0),
        lr=1e-3,
        coarse_ts=4,
        fine_ts=4,
        bbox_min=data.metadata.bbox_min,
        bbox_max=data.metadata.bbox_max,
        mesh=mesh,
    )

    global_batch = 64
    local_batch = global_batch // jax.process_count()
    sd = ShuffledDataset(f"{data_dir}/shuffled", data, seed=7, num_shards=4)
    it = sd.iterate_batches(local_batch, repeat=True)

    # Both processes must see only their own views' rays.
    my_rows = np.concatenate([sd._read_shard(i) for i in range(4)])
    print(f"p{process_id}: local_rows={my_rows.shape[0]}", flush=True)

    values = None
    for _ in range(2):
        batch = next(it)
        assert batch.shape == (local_batch, 3, 3)
        values = loop.step(jax.random.PRNGKey(5), batch)
    out = {k: round(float(v), 6) for k, v in sorted(values.items())}
    print(f"p{process_id}: METRICS {out}", flush=True)

    # Occupancy fast path across processes: dense step 1, pooled step 2.
    # The pooled budget must derive from the ASSEMBLED global batch
    # (process_count * local rows), not the local slice.
    from learn_nerf_tpu.train import OccupancyTrainLoop

    occ = OccupancyTrainLoop(
        NeRFModel(**model_kwargs),
        init_rng=jax.random.PRNGKey(1),
        lr=1e-3,
        bbox_min=data.metadata.bbox_min,
        bbox_max=data.metadata.bbox_max,
        candidates=16,
        samples=4,
        grid_resolution=8,
        update_interval=2,
        update_cells=64,
        pool_budget_per_ray=4.0,
        pool_start_step=1,
        mesh=mesh,
    )
    assert occ.shard_batch(next(it)).shape[0] == global_batch
    base = jax.random.PRNGKey(11)
    occ_values = None
    for _ in range(2):
        occ_values = occ.step_auto(base, next(it))
    occ_out = {k: round(float(v), 6) for k, v in sorted(occ_values.items())}
    print(f"p{process_id}: OCC_METRICS {occ_out}", flush=True)


if __name__ == "__main__":
    main()
