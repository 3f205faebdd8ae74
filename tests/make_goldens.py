"""Generate golden parity fixtures by running the reference implementation.

Run manually (requires /root/reference mounted):

    JAX_PLATFORMS=cpu python tests/make_goldens.py

Outputs ``tests/golden/*.npz`` consumed by ``test_parity.py``.  The fixtures
are *outputs* of the reference (inputs + expected values), pinning our
independent implementation to the reference's numerical behaviour.
"""

import os
import sys

sys.path.insert(0, "/root/reference")

import jax
import jax.numpy as jnp
import numpy as np

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")


def save(name, **arrays):
    os.makedirs(GOLDEN_DIR, exist_ok=True)
    np.savez(
        os.path.join(GOLDEN_DIR, name + ".npz"),
        **{k: np.asarray(v) for k, v in arrays.items()},
    )
    print("wrote", name, {k: np.asarray(v).shape for k, v in arrays.items()})


def main():
    from learn_nerf import render as ref_render
    from learn_nerf import model as ref_model
    from learn_nerf import ref_nerf as ref_refnerf
    from learn_nerf import instant_ngp as ref_ngp
    from learn_nerf.dataset import CameraView as RefCameraView

    rng = np.random.RandomState(1234)

    # --- ray_t_range ------------------------------------------------------
    n = 257
    origins = rng.randn(n, 3).astype(np.float32) * 2
    dirs = rng.randn(n, 3).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    bbox_min = np.array([-1.0, -0.5, -0.25], np.float32)
    bbox_max = np.array([1.0, 0.75, 0.5], np.float32)
    bbox = jnp.stack([jnp.asarray(bbox_min), jnp.asarray(bbox_max)])
    rays = jnp.stack([jnp.asarray(origins), jnp.asarray(dirs)], axis=1)
    bounds, mask = jax.vmap(lambda r: ref_render.ray_t_range(bbox, r))(rays)
    save(
        "ray_t_range",
        origins=origins,
        dirs=dirs,
        bbox_min=bbox_min,
        bbox_max=bbox_max,
        t_min=bounds[:, 0],
        t_max=bounds[:, 1],
        mask=mask,
    )

    # --- stratified + termination + fine sampling ------------------------
    key = jax.random.PRNGKey(7)
    t_min = jnp.asarray(np.abs(rng.rand(n)).astype(np.float32))
    t_max = t_min + jnp.asarray((rng.rand(n) * 3 + 0.1).astype(np.float32))
    m = jnp.asarray(rng.rand(n) > 0.2)
    samples = ref_render.RaySamples.stratified_sampling(
        t_min=t_min, t_max=t_max, mask=m, count=16, key=key
    )
    densities = jnp.asarray(np.abs(rng.randn(n, 16)).astype(np.float32) * 2)
    probs = samples.termination_probs(densities)
    fine_key = jax.random.PRNGKey(8)
    fine = samples.fine_sampling(count=24, key=fine_key, densities=densities)
    save(
        "sampling",
        t_min=t_min,
        t_max=t_max,
        mask=m,
        ts=samples.ts,
        densities=densities,
        probs=probs,
        starts=samples.starts(),
        ends=samples.ends(),
        deltas=samples.deltas(),
        fine_ts=fine.ts,
    )

    # --- compositing ------------------------------------------------------
    rgbs = jnp.asarray(rng.rand(n, 16, 3).astype(np.float32) * 2 - 1)
    background = jnp.asarray(np.array([0.3, -0.2, 0.9], np.float32))
    outputs = samples.render_rays(densities, rgbs, background)
    alphas = samples.render_alpha(densities)
    aux = {"a": jnp.asarray(rng.rand(n, 16).astype(np.float32))}
    # NOTE: reference average_aux broadcasts [N,1] vs [N] (render.py:207);
    # generate with an all-True mask where both implementations agree.
    all_true = jnp.ones(n, dtype=bool)
    samples_all = ref_render.RaySamples(
        t_min=t_min, t_max=t_max, mask=all_true, ts=samples.ts
    )
    aux_mean = samples_all.average_aux_losses(densities, aux)
    save(
        "compositing",
        rgbs=rgbs,
        background=background,
        outputs=outputs,
        alphas=alphas,
        aux_in=aux["a"],
        aux_mean=aux_mean["a"],
    )

    # --- sinusoidal embedding --------------------------------------------
    coords = jnp.asarray(rng.randn(33, 3).astype(np.float32))
    save(
        "sinusoidal",
        coords=coords,
        emb10=ref_model.sinusoidal_emb(coords, 10),
        emb4=ref_model.sinusoidal_emb(coords, 4),
    )

    # --- spherical harmonics / IDE ---------------------------------------
    v = rng.randn(65, 3).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    v = jnp.asarray(v)
    roughness = jnp.asarray(np.abs(rng.randn(65, 1)).astype(np.float32))
    sh_out = {
        f"sh{deg}": ref_refnerf.spherical_harmonic(deg, v) for deg in range(1, 9)
    }
    ide = ref_refnerf.integrated_directional_encoding(4, v, roughness)
    save("sh", coords=v, roughness=roughness, ide4=ide, **sh_out)

    # --- srgb / leaky clip -------------------------------------------------
    c = jnp.asarray(rng.rand(50, 3).astype(np.float32) * 1.4 - 0.2)
    save(
        "srgb",
        colors=c,
        srgb=ref_refnerf.linear_rgb_to_srgb(c),
        clipped=ref_refnerf._leaky_clip(c),
    )

    # --- hash grid encoding -----------------------------------------------
    x = jnp.asarray(rng.rand(41, 3).astype(np.float32) * 2.2 - 1.1)
    for tag, (grid, table, smooth) in dict(
        dense=(8, 4096, False),
        hashed=(64, 2**12, False),
        smooth=(64, 2**12, True),
        dense_smooth=(8, 4096, True),
    ).items():
        enc = ref_ngp.HashTableEncoding(
            table_size=table,
            grid_size=grid,
            bbox_min=jnp.asarray(bbox_min),
            bbox_max=jnp.asarray(bbox_max),
            feature_dim=2,
            smooth=smooth,
        )
        variables = enc.init(dict(params=jax.random.PRNGKey(3)), x)
        out = enc.apply(variables, x)
        save(
            f"hashgrid_{tag}",
            x=x,
            bbox_min=bbox_min,
            bbox_max=bbox_max,
            table=variables["params"]["table"],
            out=out,
            grid=np.array(grid),
            table_size=np.array(table),
            smooth=np.array(smooth),
        )

    # --- full vanilla model + renderer end-to-end -------------------------
    coarse = ref_model.NeRFModel(hidden_dim=32, color_layer_dim=16)
    fine = ref_model.NeRFModel(hidden_dim=48, color_layer_dim=16)
    init_key = jax.random.PRNGKey(11)
    ck, fk = jax.random.split(init_key)
    ex = jnp.zeros((1, 3))
    cp = coarse.init(dict(params=ck), ex, ex)["params"]
    fp = fine.init(dict(params=fk), ex, ex)["params"]

    n2 = 64
    origins2 = rng.randn(n2, 3).astype(np.float32) * 1.5
    dirs2 = rng.randn(n2, 3).astype(np.float32)
    dirs2 /= np.linalg.norm(dirs2, axis=-1, keepdims=True)
    rays2 = jnp.stack([jnp.asarray(origins2), jnp.asarray(dirs2)], axis=1)
    renderer = ref_render.NeRFRenderer(
        coarse=coarse,
        fine=fine,
        coarse_params=cp,
        fine_params=fp,
        background=background,
        bbox_min=jnp.asarray(bbox_min),
        bbox_max=jnp.asarray(bbox_max),
        coarse_ts=8,
        fine_ts=12,
    )
    out = renderer.render_rays(jax.random.PRNGKey(21), rays2)
    import pickle

    with open(os.path.join(GOLDEN_DIR, "vanilla_params.pkl"), "wb") as f:
        pickle.dump(
            jax.device_get({"coarse": cp, "fine": fp, "background": background}), f
        )
    save(
        "renderer_e2e",
        rays=rays2,
        background=background,
        bbox_min=bbox_min,
        bbox_max=bbox_max,
        coarse_outputs=out["coarse"]["outputs"],
        fine_outputs=out["fine"]["outputs"],
        coarse_densities=out["coarse"]["densities"],
        fine_densities=out["fine"]["densities"],
        fine_alphas=out["fine"]["alphas"],
        fine_coords=out["fine"]["coords"],
    )

    # --- reference NGP checkpoint (cross-load test) ------------------------
    ngp = ref_ngp.InstantNGPModel(
        table_sizes=[2**12] * 3,
        grid_sizes=[4, 8, 64],
        bbox_min=jnp.asarray(bbox_min),
        bbox_max=jnp.asarray(bbox_max),
    )
    xq = jnp.asarray(rng.rand(37, 3).astype(np.float32) * 1.5 - 0.7)
    dq = jnp.asarray(rng.randn(37, 3).astype(np.float32))
    dq = dq / jnp.linalg.norm(dq, axis=-1, keepdims=True)
    ngp_params = ngp.init(dict(params=jax.random.PRNGKey(5)), xq, dq)["params"]
    dens, rgb, _ = ngp.apply(dict(params=ngp_params), xq, dq)
    import pickle as _pickle

    with open(os.path.join(GOLDEN_DIR, "ngp_reference_checkpoint.pkl"), "wb") as f:
        _pickle.dump(
            jax.device_get(
                {
                    "coarse": ngp_params,
                    "fine": ngp_params,
                    "background": np.array([-1.0, -1.0, -1.0], np.float32),
                }
            ),
            f,
        )
    save(
        "ngp_reference_outputs",
        x=xq,
        d=dq,
        bbox_min=bbox_min,
        bbox_max=bbox_max,
        density=dens,
        rgb=rgb,
    )

    # --- reference Ref-NeRF end-to-end (cross-load + VJP-normal parity) ----
    refn = ref_refnerf.RefNERFModel(
        sh_degree=4,
        input_layers=2,
        mid_layers=2,
        hidden_dim=32,
        color_layer_dim=16,
    )
    xr = jnp.asarray(rng.rand(29, 3).astype(np.float32) * 1.6 - 0.8)
    dr = jnp.asarray(rng.randn(29, 3).astype(np.float32))
    dr = dr / jnp.linalg.norm(dr, axis=-1, keepdims=True)
    refn_params = refn.init(dict(params=jax.random.PRNGKey(13)), xr, dr)["params"]
    dens_r, rgb_r, aux_r = refn.apply(dict(params=refn_params), xr, dr)
    import pickle as _pkl

    with open(os.path.join(GOLDEN_DIR, "refnerf_reference_checkpoint.pkl"), "wb") as f:
        _pkl.dump(
            jax.device_get(
                {
                    "coarse": refn_params,
                    "fine": refn_params,
                    "background": np.array([-1.0, -1.0, -1.0], np.float32),
                }
            ),
            f,
        )
    save(
        "refnerf_reference_outputs",
        x=xr,
        d=dr,
        density=dens_r,
        rgb=rgb_r,
        normal_mse=aux_r["normal_mse"],
        neg_normal=aux_r["neg_normal"],
    )

    # --- reference NGP x Ref-NeRF hybrid (smooth hash grids + IDE) ---------
    ngp_ref = ref_ngp.InstantNGPRefNERFModel(
        sh_degree=4,
        table_sizes=[2**10] * 3,
        grid_sizes=[4, 8, 32],
        bbox_min=jnp.asarray(bbox_min),
        bbox_max=jnp.asarray(bbox_max),
        hidden_dim=32,
    )
    xh = jnp.asarray(rng.rand(23, 3).astype(np.float32) * 1.4 - 0.6)
    dh = jnp.asarray(rng.randn(23, 3).astype(np.float32))
    dh = dh / jnp.linalg.norm(dh, axis=-1, keepdims=True)
    ngp_ref_params = ngp_ref.init(dict(params=jax.random.PRNGKey(17)), xh, dh)[
        "params"
    ]
    dens_h, rgb_h, aux_h = ngp_ref.apply(dict(params=ngp_ref_params), xh, dh)
    with open(
        os.path.join(GOLDEN_DIR, "ngp_refnerf_reference_checkpoint.pkl"), "wb"
    ) as f:
        _pkl.dump(
            jax.device_get(
                {
                    "coarse": ngp_ref_params,
                    "fine": ngp_ref_params,
                    "background": np.array([-1.0, -1.0, -1.0], np.float32),
                }
            ),
            f,
        )
    save(
        "ngp_refnerf_reference_outputs",
        x=xh,
        d=dh,
        bbox_min=bbox_min,
        bbox_max=bbox_max,
        density=dens_h,
        rgb=rgb_h,
        normal_mse=aux_h["normal_mse"],
        neg_normal=aux_h["neg_normal"],
    )

    # --- camera rays --------------------------------------------------------
    view = RefCameraView(
        camera_direction=(0.3, -0.5, 0.81),
        camera_origin=(1.0, 2.0, -3.0),
        x_axis=(0.8, 0.6, 0.0),
        y_axis=(0.0, 0.6, -0.8),
        x_fov=1.047,
        y_fov=0.785,
    )
    save("camera", rays=view.bare_rays(17, 13))

    print("done")


if __name__ == "__main__":
    main()
