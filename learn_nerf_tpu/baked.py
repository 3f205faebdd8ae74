"""Baked inference representation for Instant-NGP fields (SNeRG-style).

The trained NGP frame renderer is gather-count-bound: every field sample
pays 8 corner gathers per level group (16 levels -> 8 groups -> 64
gathers) plus the density MLP, against XLA's ~110M-gathers/s ceiling
(docs/DESIGN.md section 3).  None of that is needed at inference: the
*spatial* part of the model — hash encoding + density MLP, everything up
to the ``density_dim`` feature vector whose first channel is the log
density — is a fixed function of position once training ends.

``bake_instant_ngp`` sweeps that spatial stack once over a dense
``resolution^3`` lattice (one device program, chunked with ``lax.map``)
and stores the feature vectors in a single table.  ``BakedInstantNGP``
then evaluates the field with ONE trilinearly-interpolated gather group
(8 corner gathers of ``density_dim``-wide rows — 8x fewer than the live
hash stack) followed by the exact, unchanged color MLP; per-sample
view-dependent color is preserved bit-for-bit in structure (only the
spatial features are approximated by trilinear interpolation between
lattice vertices — at lattice vertices the baked field is exact up to
storage-dtype rounding).

The baked model satisfies the :class:`~learn_nerf_tpu.models.base.FieldModel`
interface, so every downstream consumer — the occupancy renderer, pooled
frame tiles, mesh extraction, the render CLIs — works unchanged; the
render-family CLIs expose it as ``--baked <resolution>``.

Replaces the reference's chunked render loop use case
(``learn_nerf/scripts/render_nerf.py:85-97``); technique after SNeRG
(arXiv:2103.14645) adapted to this framework's occupancy/pooled path
(deferred shading is deliberately NOT used: the per-sample color MLP is
a small matmul stack, so baking only the gather-heavy spatial stack keeps
the baked render within rounding of the live one).
"""

import time
from typing import Tuple

import jax
import jax.numpy as jnp

from . import nn
from .models.base import FieldModel, FieldOutput
from .models.instant_ngp import InstantNGPModel
from .ops.encoding import sinusoidal_features
from .ops.hashgrid import corner_weights_and_coords

Array = jnp.ndarray


class BakedInstantNGP(FieldModel):
    """Dense-grid spatial field + the original NGP color head.

    Params: ``grid`` — the spatial feature table (vertex-sampled,
    trilinearly interpolated; channel 0 of each logical row is the log
    density) — plus the color-head Dense layers copied verbatim from
    the trained model by :func:`bake_instant_ngp`.

    ``pack`` trades memory for gather count (premise that gather COUNT,
    not row width, sets the cost: not yet measured on the H100 —
    docs/DESIGN.md section 3): each table row duplicates the features of
    ``pack`` cell corners (1, 2, 4, or 8), so a trilinear sample costs
    ``8 / pack`` gathers at ``pack``x the memory.  Corner order is the bit order of
    :data:`~learn_nerf_tpu.ops.hashgrid._CORNERS` (x=bit2, y=bit1,
    z=bit0); packing consumes the LOW bits (z, then y, then x), so the
    gathered ``[8/pack, pack, F]`` rows reshape to the standard
    ``[8, F]`` corner order and the interpolation below is bit-identical
    to ``pack=1``.

    **Physical storage is segmented: rows are ``pack * 128`` lanes
    wide.**  The layout exists for hardware that pads a table's minor
    dimension up to 128 lanes, where a ``[rows, 16]`` table would cost 8x
    its size; that premise is not yet measured on the H100 (ROADMAP D2
    compares it with a plain ``[cells, pack * F]`` table).  The table is
    stored in SEGMENTS: with ``S = 128 //
    density_dim`` consecutive logical rows per 128-lane block, physical
    row ``n``, segment ``c`` (lanes ``[128c, 128c+128)``) holds the
    corner-shift-``c`` features of logical rows ``nS .. nS+S-1`` —
    logical row ``i``'s pack block lives at physical row ``i // S``,
    lane offset ``(i % S) * density_dim`` within each segment.  Zero
    padding, zero in-program relayout, and the bake can BUILD every
    segment with 128-lane-aligned row shifts of the pack-1 table (no
    wide logical tensor ever exists, :func:`pack_baked_grid`).  The
    sub-row select is a mask-and-sum (elementwise; a
    ``take_along_axis`` would lower to a second gather).
    When ``density_dim`` does not divide 128 the layout falls back to
    one logical row per physical row.
    """

    resolution: int
    bbox_min: Tuple[float, float, float]
    bbox_max: Tuple[float, float, float]
    d_freqs: int = 4
    hidden_dim: int = 64
    density_dim: int = 16
    color_layers: int = 2
    pack: int = 1
    #: Mirrored from the source model so a --bf16 checkpoint's color head
    #: keeps running in the SAME arithmetic after baking — otherwise the
    #: baked-vs-live delta conflates dtype rounding with bake error.
    compute_dtype: str = "float32"

    @nn.compact
    def __call__(self, x: Array, d: Array) -> FieldOutput:
        r = self.resolution
        p = self.pack
        f = self.density_dim
        if p not in (1, 2, 4, 8):
            raise ValueError(f"pack must be 1, 2, 4, or 8 (got {p})")
        s = physical_rows_per_row(f)
        nrows = -(-(r**3) // s)
        grid = self.param(
            "grid",
            lambda key: jnp.zeros((nrows, p * s * f), jnp.bfloat16),
        )
        bbox_min = jnp.asarray(self.bbox_min, dtype=jnp.float32)
        bbox_max = jnp.asarray(self.bbox_max, dtype=jnp.float32)
        coords, weights = corner_weights_and_coords(
            x, r, bbox_min, bbox_max, smooth=False
        )
        # Row corners = corners whose packed (low) offset bits are zero:
        # stride p over the 8 (p=1 -> all, p=2 -> 0,2,4,6, p=4 -> 0,4,
        # p=8 -> 0).  Dense vertex index (the lattice is its own table).
        rows = coords[..., ::p, :]
        cx = rows[..., 0].astype(jnp.int32)
        cy = rows[..., 1].astype(jnp.int32)
        cz = rows[..., 2].astype(jnp.int32)
        idx = cx + r * (cy + r * cz)
        if s > 1:
            # One gather per row group, then an exact mask-sum select of
            # the logical sub-row within each 128-lane segment (adding
            # 0.0 never changes a float, so this is bit-identical to
            # gathering [..., p*f] directly).
            feats = jnp.take(grid, idx // s, axis=0)  # [..., 8/p, p*s*f]
            feats = feats.reshape(*feats.shape[:-1], p, s, f).astype(
                jnp.float32
            )
            onehot = (idx % s)[..., None] == jnp.arange(s, dtype=jnp.int32)
            feats = jnp.sum(
                jnp.where(onehot[..., None, :, None], feats, 0.0), axis=-2
            )  # [..., 8/p, p, f]
        else:
            feats = jnp.take(grid, idx, axis=0).astype(jnp.float32)
        # [..., 8/p, p, f] (or [..., 8/p, p*f] when s == 1) -> [..., 8, f]:
        # segment order matches corner-bit order, so this is the standard
        # corner axis.
        feats = feats.reshape(*idx.shape[:-1], 8, f)
        out = jnp.sum(weights[..., None] * feats, axis=-2)  # [..., F]

        density = jnp.exp(out[..., 0:1])
        d_emb = sinusoidal_features(d, self.d_freqs)
        cdtype = jnp.dtype(self.compute_dtype)
        h = jnp.concatenate([d_emb, out], axis=-1).astype(cdtype)
        for _ in range(self.color_layers):
            h = nn.relu(nn.Dense(self.hidden_dim, dtype=cdtype)(h))
        color = nn.tanh(nn.Dense(3, dtype=cdtype)(h).astype(jnp.float32))
        return density, color, {}


def physical_rows_per_row(width: int) -> int:
    """Logical rows per 128-lane physical row (1 when width ∤ 128)."""
    if width <= 128 and 128 % width == 0:
        return 128 // width
    return 1


def to_physical(grid: Array, width: int) -> Array:
    """Reshape a ``[rows, width]`` logical table to tile-aligned physical
    ``[ceil(rows / S), S * width]`` storage (S 128-lane-packed logical
    rows per physical row; zero-padded tail rows are never gathered —
    the max logical index is ``rows - 1``).  See
    :class:`BakedInstantNGP` for why."""
    rows, w = grid.shape
    assert w == width
    s = physical_rows_per_row(width)
    if s == 1:
        return grid
    nrows = -(-rows // s)
    pad = nrows * s - rows
    if pad:
        grid = jnp.concatenate(
            [grid, jnp.zeros((pad, width), grid.dtype)], axis=0
        )
    return grid.reshape(nrows, s * width)


def _segments_from_physical(phys: Array, resolution: int, pack: int) -> Array:
    """Segmented packed table from the PHYSICAL pack-1 table, using only
    128-lane-aligned row shifts — no wide logical tensor ever exists.

    ``phys`` is ``[r^3 / S, 128]`` (S consecutive x-fastest logical rows
    per physical row).  A corner +1 shift along z (logical +r^2) or y
    (logical +r, per z-plane) is a whole-physical-row shift because S
    divides r; the x shift (+1) moves features one ``F``-lane sub-row
    with a carry from the next physical row.  Boundary rows clamp to
    themselves exactly like the logical per-axis clamp (the tail rows of
    a flat z shift ARE the cz = r-1 plane, etc.).  Requires
    ``resolution % S == 0``.
    """
    r = resolution
    n, lanes = phys.shape
    assert lanes == 128
    s = (r**3) // n
    assert r % s == 0 and n == r**3 // s

    def shz(a):
        k = (r * r) // s
        return jnp.concatenate([a[k:], a[-k:]], axis=0)

    def shy(a):
        x = a.reshape(r, n // r, 128)
        k = r // s
        x = jnp.concatenate([x[:, k:], x[:, -k:]], axis=1)
        return x.reshape(n, 128)

    def shx(a):
        f = 128 // s
        x = a.reshape(r * r, r // s, 128)
        main = x[..., f:]
        carry = jnp.concatenate([x[:, 1:, :f], x[:, -1:, 128 - f:]], axis=1)
        return jnp.concatenate([main, carry], axis=-1).reshape(n, 128)

    segs = [phys, shz(phys)]
    if pack >= 4:
        py = shy(phys)
        segs += [py, shz(py)]
    if pack == 8:
        px = shx(phys)
        pxy = shy(px)
        segs += [px, shz(px), pxy, shz(pxy)]
    return jnp.concatenate(segs, axis=1)


def pack_baked_grid(grid: Array, resolution: int, pack: int) -> Array:
    """Segmented packed table from the LOGICAL ``[r^3, F]`` table
    (general fallback for resolutions the aligned shift path cannot
    serve; materializes wide logical intermediates, so production-scale
    grids go through :func:`_segments_from_physical` instead).

    Segment ``c`` holds the corner-shift-``c`` features for the low
    ``log2(pack)`` offset bits in corner-bit order (x=bit2, y=bit1,
    z=bit0), +1 shifts clamped at the boundary (those rows are never
    gathered as bases: the interpolation floors to ``resolution - 2``).
    Output format matches :class:`BakedInstantNGP`:
    ``[ceil(r^3 / S), pack * S * F]`` with each 128-lane (or F-lane when
    ``S == 1``) segment block tile-aligned via :func:`to_physical`.
    """
    r = resolution
    feat = int(grid.shape[-1])
    if pack == 1:
        return to_physical(grid, feat)
    if pack not in (2, 4, 8):
        raise ValueError(f"pack must be 1, 2, 4, or 8 (got {pack})")
    g = grid.reshape(r, r, r, -1)  # [z, y, x, F]

    def sh(a, axis):  # clamped +1 shift along a lattice axis
        return jnp.concatenate(
            [
                jax.lax.slice_in_dim(a, 1, r, axis=axis),
                jax.lax.slice_in_dim(a, r - 1, r, axis=axis),
            ],
            axis=axis,
        )

    parts = [g, sh(g, 0)]  # dz = 0, 1
    if pack >= 4:
        gy = sh(g, 1)
        parts += [gy, sh(gy, 0)]  # (dy=1, dz=0), (1, 1)
    if pack == 8:
        gx = sh(g, 2)
        gxy = sh(gx, 1)
        parts += [gx, sh(gx, 0), gxy, sh(gxy, 0)]
    return jnp.concatenate(
        [to_physical(p.reshape(r**3, feat), feat) for p in parts], axis=1
    )


def _make_sweep(model: InstantNGPModel, r: int, dtype):
    """Jitted dense-lattice sweep: ``params -> (sweep_fn, physical?)``.

    Params are a jit ARGUMENT (never a closure capture — a captured
    param tree lowers as program constants and ships to the remote
    compiler; tests/test_constants.py gates this).  One device program:
    r chunks of r^2 lattice vertices, positions derived on device (no
    host-side point tensor).

    When the 128-lane physical packing divides each z-plane exactly
    (``S | r^2``, true for every even production resolution at
    density_dim 16), each chunk emits ``[r^2/S, 128]`` tile-aligned rows
    and the sweep output IS the physical pack-1 table — no narrow
    logical array is ever a program output (see
    :class:`BakedInstantNGP`'s layout note).
    """
    bbox_min = jnp.asarray(model.bbox_min, dtype=jnp.float32)
    bbox_max = jnp.asarray(model.bbox_max, dtype=jnp.float32)
    s = physical_rows_per_row(model.density_dim)
    physical = s > 1 and (r * r) % s == 0

    @jax.jit
    def sweep(params):
        def chunk(z):
            ids = jnp.arange(r * r, dtype=jnp.int32)
            cx = ids % r
            cy = ids // r
            coords = jnp.stack(
                [cx, cy, jnp.full_like(cx, z)], axis=-1
            ).astype(jnp.float32)
            pts = bbox_min + coords / (r - 1) * (bbox_max - bbox_min)
            feats = model.apply(
                dict(params=params), pts, jnp.zeros_like(pts), spatial_only=True
            )
            feats = feats.astype(dtype)
            if physical:
                feats = feats.reshape(r * r // s, s * feats.shape[-1])
            return feats

        out = jax.lax.map(chunk, jnp.arange(r, dtype=jnp.int32))
        # Collapse the chunk axis INSIDE the program: leading-dim merges
        # of a row-major [r, rows/chunk, lanes] stack are layout-free
        # here, while a separate host-dispatched reshape program pays a
        # whole-table copy (4.3 GB at 512^3) in its own memory budget.
        return out.reshape(-1, out.shape[-1])

    return sweep, physical


def bake_instant_ngp(
    model: InstantNGPModel,
    params,
    resolution: int,
    dtype=jnp.bfloat16,
    pack: int = 1,
    verbose: bool = True,
) -> Tuple[BakedInstantNGP, dict]:
    """Sweep the trained spatial stack onto a dense grid.

    :param model: the trained ``InstantNGPModel`` (plain NGP; the Ref-NeRF
        hybrid's normals need the live C1 encoding and cannot bake this way).
    :param params: its trained param tree (``checkpoint["fine"]``).
    :param resolution: lattice vertices per axis (vertex i at
        ``bbox_min + i/(resolution-1) * (bbox_max - bbox_min)``, matching
        the trilinear indexing of :func:`ops.hashgrid.corner_weights_and_coords`).
    :param dtype: grid storage dtype; bfloat16 halves memory (512^3 x 16
        features = 4.3 GB) at ~3 significant digits, enough for densities
        through ``exp`` at frame-PSNR fidelity — measure with
        ``eval_psnr --baked`` if in doubt, or pass ``jnp.float32``.
    :param pack: corners per table row (1, 2, 4, or 8): ``pack``x the
        grid memory for ``8 / pack`` count-bound gathers per sample,
        bit-identical outputs (see :class:`BakedInstantNGP`).
    :return: ``(baked_model, baked_params)`` ready for any FieldModel
        consumer; combine as ``dict(fine=baked_params, background=...)``
        for the render CLIs.
    """
    if not isinstance(model, InstantNGPModel):
        raise ValueError(
            "--baked supports the plain Instant-NGP model only "
            f"(got {type(model).__name__})"
        )
    r = resolution
    feat_dim = int(model.density_dim)
    s1 = physical_rows_per_row(feat_dim)
    sweep, sweep_physical = _make_sweep(model, r, dtype)

    t0 = time.time()
    grid = sweep(params)
    # Pack + segment in ONE donated program so no sub-128-lane table is
    # ever a program output (see BakedInstantNGP's layout note) and the
    # pack-1 buffer is released into the repack.
    if pack != 1:
        if sweep_physical and r % s1 == 0:
            grid = jax.jit(
                lambda g: _segments_from_physical(g, r, pack),
                donate_argnums=0,
            )(grid)
        else:
            grid = jax.jit(
                lambda g: pack_baked_grid(g.reshape(r**3, feat_dim), r, pack),
                donate_argnums=0,
            )(grid)
    elif not sweep_physical:
        grid = jax.jit(
            lambda g: to_physical(g, feat_dim), donate_argnums=0
        )(grid)
    jax.block_until_ready(grid)

    # Copy the color-head Dense layers: the source names them
    # Dense_{density_layers+1} .. Dense_{density_layers+color_layers+1}
    # (creation order in InstantNGPModel.__call__); the baked module's own
    # compact order names its color stack Dense_0 ...
    first_color = model.density_layers + 1
    baked_params = {"grid": grid}
    for i in range(model.color_layers + 1):
        baked_params[f"Dense_{i}"] = params[f"Dense_{first_color + i}"]

    baked = BakedInstantNGP(
        resolution=r,
        bbox_min=tuple(model.bbox_min),
        bbox_max=tuple(model.bbox_max),
        d_freqs=model.d_freqs,
        hidden_dim=model.hidden_dim,
        density_dim=model.density_dim,
        color_layers=model.color_layers,
        pack=pack,
        compute_dtype=model.compute_dtype,
    )
    if verbose:
        gb = grid.size * grid.dtype.itemsize / 1e9
        print(
            f"baked {r}^3 x {feat_dim} spatial grid "
            f"({gb:.2f} GB {grid.dtype}, pack {pack}, "
            f"{grid.shape[-1]}-lane physical rows) "
            f"in {time.time() - t0:.1f} s",
            flush=True,
        )
    return baked, baked_params
