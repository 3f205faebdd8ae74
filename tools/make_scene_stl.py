"""Generate a multi-feature compound STL scene for benchmark datasets.

Matched-PSNR measurements need a scene that is *not* a trivial cube: this
builds a compound mesh (torus + sphere +
boxes + cone + cylinder, thin and thick features, concavities, occlusion)
and writes a binary STL that ``bin/simple_dataset`` turns into a NeRF
dataset (the tool normalizes the mesh to unit size, so absolute scale here
is irrelevant).

Usage: python tools/make_scene_stl.py out.stl
"""


import sys

import numpy as np


def quad(a, b, c, d):
    return [(a, b, c), (a, c, d)]


def uv_sphere(center, radius, n_lat=24, n_lon=32):
    tris = []
    cs = np.asarray(center)
    for i in range(n_lat):
        t0, t1 = np.pi * i / n_lat, np.pi * (i + 1) / n_lat
        for j in range(n_lon):
            p0, p1 = 2 * np.pi * j / n_lon, 2 * np.pi * (j + 1) / n_lon

            def pt(t, p):
                return cs + radius * np.array(
                    [np.sin(t) * np.cos(p), np.sin(t) * np.sin(p), np.cos(t)]
                )

            a, b, c, d = pt(t0, p0), pt(t1, p0), pt(t1, p1), pt(t0, p1)
            if i == 0:
                tris.append((a, b, c))
            elif i == n_lat - 1:
                tris.append((a, b, d))
            else:
                tris += quad(a, b, c, d)
    return tris


def torus(center, big_r, small_r, n_u=48, n_v=20, axis="z"):
    tris = []
    cs = np.asarray(center)
    for i in range(n_u):
        u0, u1 = 2 * np.pi * i / n_u, 2 * np.pi * (i + 1) / n_u
        for j in range(n_v):
            v0, v1 = 2 * np.pi * j / n_v, 2 * np.pi * (j + 1) / n_v

            def pt(u, v):
                r = big_r + small_r * np.cos(v)
                p = np.array([r * np.cos(u), r * np.sin(u), small_r * np.sin(v)])
                if axis == "x":
                    p = p[[2, 0, 1]]
                elif axis == "y":
                    p = p[[0, 2, 1]]
                return cs + p

            tris += quad(pt(u0, v0), pt(u1, v0), pt(u1, v1), pt(u0, v1))
    return tris


def box(center, size):
    cs, hs = np.asarray(center), np.asarray(size) / 2
    corners = [
        cs + hs * np.array([sx, sy, sz])
        for sx in (-1, 1)
        for sy in (-1, 1)
        for sz in (-1, 1)
    ]
    # corner index = 4*x + 2*y + z with (-1 -> 0, 1 -> 1)
    faces = [
        (0, 1, 3, 2),  # -x
        (4, 6, 7, 5),  # +x
        (0, 4, 5, 1),  # -y
        (2, 3, 7, 6),  # +y
        (0, 2, 6, 4),  # -z
        (1, 5, 7, 3),  # +z
    ]
    tris = []
    for f in faces:
        tris += quad(*(corners[i] for i in f))
    return tris


def cone(center, radius, height, n=32):
    tris = []
    cs = np.asarray(center)
    apex = cs + np.array([0, 0, height])
    for j in range(n):
        p0, p1 = 2 * np.pi * j / n, 2 * np.pi * (j + 1) / n
        a = cs + radius * np.array([np.cos(p0), np.sin(p0), 0])
        b = cs + radius * np.array([np.cos(p1), np.sin(p1), 0])
        tris.append((a, b, apex))
        tris.append((a, cs, b))
    return tris


def cylinder(center, radius, height, n=32):
    tris = []
    cs = np.asarray(center)
    top = np.array([0, 0, height])
    for j in range(n):
        p0, p1 = 2 * np.pi * j / n, 2 * np.pi * (j + 1) / n
        a = cs + radius * np.array([np.cos(p0), np.sin(p0), 0])
        b = cs + radius * np.array([np.cos(p1), np.sin(p1), 0])
        tris += quad(a, b, b + top, a + top)
        tris.append((a, cs, b))
        tris.append((a + top, b + top, cs + top))
    return tris


def scene():
    tris = []
    # Flat torus as the "ring road" with thin features.
    tris += torus((0, 0, -0.25), 0.75, 0.12)
    # Central sphere resting inside the torus.
    tris += uv_sphere((0, 0, 0.05), 0.35)
    # Small sphere stack (occlusion / fine detail).
    tris += uv_sphere((0.45, 0.45, 0.35), 0.12, n_lat=16, n_lon=24)
    # Tilted slab box and a tall thin pillar.
    tris += box((-0.55, 0.3, 0.1), (0.35, 0.5, 0.08))
    tris += box((0.55, -0.4, 0.2), (0.1, 0.1, 0.9))
    # Cone and cylinder off-axis.
    tris += cone((-0.4, -0.5, -0.3), 0.25, 0.7)
    tris += cylinder((0.1, 0.6, -0.35), 0.15, 0.5, n=24)
    # A vertical torus threaded over the pillar (interlocking geometry).
    tris += torus((0.55, -0.4, 0.45), 0.28, 0.07, axis="y", n_u=36, n_v=14)
    return tris


def write_stl(path, tris):
    """Thin adapter over the package's binary STL writer (one serializer
    in the repo; this one just flattens the raw triangle list)."""
    import sys

    sys.path.insert(0, "/root/repo")
    from learn_nerf_tpu.mesh import write_stl as _write

    verts = np.asarray(tris, dtype=np.float32).reshape(-1, 3)
    faces = np.arange(len(verts), dtype=np.int64).reshape(-1, 3)
    _write(path, verts, faces)


if __name__ == "__main__":
    out = sys.argv[1] if len(sys.argv) > 1 else "scene.stl"
    tris = scene()
    write_stl(out, tris)
    print(f"wrote {out}: {len(tris)} triangles")
