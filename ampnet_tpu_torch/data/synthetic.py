"""Synthetic ALS-like scene generator, the port's own copy of
``ampnet_tpu/data/synthetic.py``: the same draws from ``np.random.Generator``
in the same order, so one seed gives the same scene bit for bit.

The reference repo's LiDAR data is not distributable (its large blobs are absent from
the snapshot), so the framework ships a procedural generator producing clouds with the
same canonical 13-column schema and class structure: ground-level background, vertical
pylon clusters (class 15), catenary power-line arcs between pylons (class 14), and two
vegetation strata (3/4/5). Used by unit tests, benchmarks and the end-to-end demo
pipeline; real LAS tiles drop into the exact same code path via data/las_io.py.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ampnet_tpu_torch.data.schema import COL, NUM_CANONICAL_COLS, remap_segmentation_labels


def synthetic_scene(
    rng: np.random.Generator,
    n_points: int = 20000,
    extent_m: float = 100.0,
    n_pylons: int = 2,
    with_noise_classes: bool = False,
) -> np.ndarray:
    """One window-sized scene as a canonical [N, 13] array (normalized features)."""
    parts = []

    def feat_block(n, cls, x, y, z_m, nir_boost=0.0):
        pc = np.zeros((n, NUM_CANONICAL_COLS), np.float32)
        pc[:, COL.X] = x / extent_m
        pc[:, COL.Y] = y / extent_m
        pc[:, COL.Z] = np.clip(z_m, 0, 100.0) / 100.0
        pc[:, COL.CLASS] = cls
        pc[:, COL.I] = rng.uniform(0, 0.5, n)
        r = rng.uniform(0.1, 0.5, n)
        pc[:, COL.R] = r
        pc[:, COL.G] = rng.uniform(0.1, 0.5, n)
        pc[:, COL.B] = rng.uniform(0.1, 0.5, n)
        nir = np.clip(r + nir_boost + rng.normal(0, 0.05, n), 1e-3, 1.0)
        pc[:, COL.NIR] = nir
        pc[:, COL.NDVI] = np.clip((nir - r) / (nir + r), 0, 1)
        pc[:, COL.X_RAW] = x
        pc[:, COL.Y_RAW] = y
        pc[:, COL.Z_RAW] = np.clip(z_m, 0, 100.0)
        return pc

    n_bg = int(n_points * 0.35)
    n_low = int(n_points * 0.25)
    n_high = int(n_points * 0.25)
    n_tower = int(n_points * 0.08)
    n_lines = n_points - n_bg - n_low - n_high - n_tower
    if n_pylons == 0:
        # landscape scene (reference 'pc_' windows): no towers or lines — their
        # point budget folds into vegetation so classification datasets get
        # genuine negatives (LidarDataset.get_labels_cls semantics)
        n_low += n_tower
        n_high += n_lines
        n_tower = n_lines = 0

    # background clutter near ground
    parts.append(
        feat_block(
            n_bg,
            1,
            rng.uniform(0, extent_m, n_bg),
            rng.uniform(0, extent_m, n_bg),
            np.abs(rng.normal(0.5, 0.4, n_bg)),
        )
    )
    # low/medium vegetation: patchy, 0.5–6 m, high NDVI
    cx, cy = rng.uniform(0, extent_m, 8), rng.uniform(0, extent_m, 8)
    which = rng.integers(0, 8, n_low)
    parts.append(
        feat_block(
            n_low,
            rng.choice([3, 4], n_low),
            np.clip(cx[which] + rng.normal(0, 5, n_low), 0, extent_m),
            np.clip(cy[which] + rng.normal(0, 5, n_low), 0, extent_m),
            rng.uniform(0.5, 6.0, n_low),
            nir_boost=0.4,
        )
    )
    # high vegetation: tree crowns 8–25 m
    cx, cy = rng.uniform(0, extent_m, 6), rng.uniform(0, extent_m, 6)
    which = rng.integers(0, 6, n_high)
    parts.append(
        feat_block(
            n_high,
            5,
            np.clip(cx[which] + rng.normal(0, 4, n_high), 0, extent_m),
            np.clip(cy[which] + rng.normal(0, 4, n_high), 0, extent_m),
            rng.uniform(8.0, 25.0, n_high),
            nir_boost=0.5,
        )
    )
    # pylons: tight vertical columns up to ~30 m
    px = np.linspace(extent_m * 0.2, extent_m * 0.8, n_pylons)
    py = np.full(n_pylons, extent_m * 0.5)
    per = n_tower // max(n_pylons, 1)
    for i in range(n_pylons):
        k = per if i < n_pylons - 1 else n_tower - per * (n_pylons - 1)
        z = rng.uniform(0, 30.0, k)
        spread = 2.0 * (1.0 - z / 35.0)  # lattice narrows with height
        parts.append(
            feat_block(
                k,
                15,
                px[i] + rng.normal(0, 1, k) * spread,
                py[i] + rng.normal(0, 1, k) * spread,
                z,
            )
        )
    # power lines: catenary arcs between pylons (or a straight span if 1 pylon)
    t = rng.uniform(0, 1, n_lines)
    x0, x1 = (px[0], px[-1]) if n_pylons > 1 else (0.0, extent_m)
    sag = 4.0
    parts.append(
        feat_block(
            n_lines,
            14,
            x0 + t * (x1 - x0) + rng.normal(0, 0.2, n_lines),
            extent_m * 0.5 + rng.normal(0, 0.3, n_lines),
            28.0 - sag * 4 * t * (1 - t) + rng.normal(0, 0.2, n_lines),
        )
    )
    if with_noise_classes:
        n_noise = max(n_points // 50, 10)
        parts.append(
            feat_block(
                n_noise,
                rng.choice([7, 2, 8, 13, 30], n_noise),
                rng.uniform(0, extent_m, n_noise),
                rng.uniform(0, extent_m, n_noise),
                rng.uniform(0, 40, n_noise),
            )
        )
    pc = np.concatenate(parts, axis=0)
    return pc[rng.permutation(len(pc))]


def _spectral(rng, n, kind, calib):
    """Class-conditional (I, R, G, B, NIR) samples with per-scene calibration drift
    and per-point sensor noise. Distributions deliberately OVERLAP between classes
    (dry grass vs soil, building roofs vs shadowed canopy) so spectral features are
    informative but not trivially separable — unlike the easy generator, whose
    nir_boost makes NDVI a perfect class oracle."""
    gain_i, gain_nir, off = calib
    mu = {
        #            I     R     G     B     NIR
        "soil":     (0.30, 0.34, 0.32, 0.28, 0.44),
        "asphalt":  (0.18, 0.22, 0.22, 0.22, 0.24),
        "roof":     (0.45, 0.40, 0.38, 0.36, 0.36),
        "metal":    (0.60, 0.26, 0.27, 0.28, 0.22),
        "grass":    (0.32, 0.24, 0.34, 0.20, 0.52),
        "drygrass": (0.33, 0.33, 0.33, 0.22, 0.42),
        "canopy":   (0.28, 0.18, 0.30, 0.16, 0.60),
    }[kind]
    s = np.empty((n, 5), np.float32)
    for j, m in enumerate(mu):
        s[:, j] = m + rng.normal(0, 0.08, n)
    # shadowed returns: a patchy fraction of every class loses most signal
    shadow = rng.uniform(size=n) < 0.15
    s[shadow] *= rng.uniform(0.3, 0.6, (shadow.sum(), 1))
    s[:, 0] = s[:, 0] * gain_i + off
    s[:, 4] = s[:, 4] * gain_nir + off
    # no-NIR returns (sensor dropouts): NDVI degenerates for these points
    s[rng.uniform(size=n) < 0.05, 4] = 0.0
    return np.clip(s, 0.0, 1.0)


def synthetic_scene_hard(
    rng: np.random.Generator,
    n_points: int = 20000,
    extent_m: float = 100.0,
    n_pylons: int = 2,
    with_ground: bool = True,
) -> np.ndarray:
    """A deliberately HARD ALS-like scene as a canonical [N, 13] array.

    Built for quality benchmarking after the easy generator saturated (the
    JAX package's flagship reached mIoU 0.9625 on it, VERDICT.md). Hardness
    axes, each mirroring a real-ALS failure mode of the reference's Catalan data
    (the reference's README.md:1-8, data_proc/generate_train_test_lists.py:106-210):

    * class imbalance: background ≫ vegetation ≫ lines/tower (~1.5 % / ~1 %);
    * geometric confusers in the background class: buildings (tree-height, low
      NDVI), thin vertical poles (mini-pylons), mid-air clutter;
    * power lines routed THROUGH canopy: corridor at a random angle with tall
      crowns planted within a few metres of the conductors, tops at wire height;
    * multi-conductor spans (2-3 parallel wires + shield wire) with catenary sag;
    * pylons of varying height/lean with cross-arms (line-like geometry), some
      truncated by the tile edge;
    * density gradient across the swath (flight-line overlap), elliptical dropout
      holes (occlusion), and low-density under-canopy ground;
    * spectral noise: per-scene calibration drift, per-point channel noise,
      shadowed returns, 5 % NIR dropouts — NDVI overlaps across classes;
    * vegetation height continuum: low veg up to 6 m, crowns from 7 m with
      multi-return points filling the crown volume down to near-trunk level.

    z (col 2/12) is height-above-ground in metres — terrain is applied by the
    synth CLI on top. When ``with_ground``, ASPRS class-2 ground points are
    included (the CLI then skips its own flat ground plane).
    """
    E = float(extent_m)
    parts = []
    calib = (rng.uniform(0.7, 1.3), rng.uniform(0.75, 1.2), rng.normal(0, 0.03))

    # ---- density field: two overlapping swaths + dropout holes ----------------
    swath_dir = rng.uniform(0, np.pi)
    sd = np.array([np.cos(swath_dir), np.sin(swath_dir)])
    overlap_c = rng.uniform(0.3, 0.7) * E
    overlap_w = rng.uniform(0.15, 0.35) * E
    holes = [(rng.uniform(0, E, 2), rng.uniform(0.05, 0.15) * E,
              rng.uniform(0.4, 1.0))  # (center, radius, y-squash) ellipses
             for _ in range(rng.integers(2, 5))]

    def keep_mask(x, y):
        along = x * sd[0] + y * sd[1]
        dens = 0.45 + 0.55 * np.exp(-0.5 * ((along - overlap_c) / overlap_w) ** 2)
        keep = rng.uniform(size=len(x)) < dens
        for (hc, hr, sq) in holes:
            d2 = ((x - hc[0]) / hr) ** 2 + ((y - hc[1]) / (hr * sq)) ** 2
            keep &= (d2 > 1.0) | (rng.uniform(size=len(x)) < 0.05)
        return keep

    def emit(cls, kind, x, y, z_m, thin=True):
        x = np.asarray(x, np.float32)
        y = np.asarray(y, np.float32)
        z_m = np.broadcast_to(np.asarray(z_m, np.float32), x.shape)
        inside = (x >= 0) & (x <= E) & (y >= 0) & (y <= E)  # tile-edge truncation
        x, y, z_m = x[inside], y[inside], z_m[inside]
        if thin and len(x):
            k = keep_mask(x, y)
            x, y, z_m = x[k], y[k], z_m[k]
        n = len(x)
        if n == 0:
            return
        pc = np.zeros((n, NUM_CANONICAL_COLS), np.float32)
        pc[:, COL.X] = x / E
        pc[:, COL.Y] = y / E
        z_c = np.clip(z_m, 0, 100.0)
        pc[:, COL.Z] = z_c / 100.0
        pc[:, COL.CLASS] = cls
        spec = _spectral(rng, n, kind, calib)
        pc[:, COL.I : COL.NIR + 1] = spec
        nir, r = spec[:, 4], spec[:, 1]
        pc[:, COL.NDVI] = np.clip(
            ((nir - r) / np.maximum(nir + r, 1e-9) + 1.0) / 2.0, 0, 1
        )
        pc[:, COL.X_RAW] = x
        pc[:, COL.Y_RAW] = y
        pc[:, COL.Z_RAW] = z_c
        parts.append(pc)

    # point budget (pre-thinning ~1/0.6 oversample; trimmed to n_points at the end)
    B = int(n_points / 0.62)
    frac = {"bg": 0.30, "bld": 0.16, "pole": 0.015, "low": 0.22, "high": 0.24,
            "lines": 0.015, "tower": 0.012}
    if n_pylons == 0:
        # landscape tile: infrastructure budget folds into vegetation, but the
        # building/pole confusers stay (classification negatives must be hard too)
        frac["low"] += frac["lines"]
        frac["high"] += frac["tower"]
        frac["lines"] = frac["tower"] = 0.0
    cnt = {k: int(B * v) for k, v in frac.items()}

    # ---- transmission corridor geometry --------------------------------------
    theta = rng.uniform(0, np.pi)
    cdir = np.array([np.cos(theta), np.sin(theta)])
    perp = np.array([-cdir[1], cdir[0]])
    mid = rng.uniform(0.3, 0.7, 2) * E
    # pylon centers along the corridor, first/last possibly outside the tile
    span = rng.uniform(0.55, 0.9) * E
    t_py = np.linspace(-span / 2, span / 2, max(n_pylons, 2))
    py_xy = mid[None, :] + t_py[:, None] * cdir[None, :]
    py_h = rng.uniform(16.0, 38.0, len(t_py))

    # ---- background: soil/asphalt clutter near ground + rare mid-air noise ----
    n = cnt["bg"]
    x, y = rng.uniform(0, E, n), rng.uniform(0, E, n)
    z = np.abs(rng.normal(0.4, 0.6, n))
    kind = np.where(rng.uniform(size=n) < 0.3, 1, 0)
    emit(1, "soil", x[kind == 0], y[kind == 0], z[kind == 0])
    emit(1, "asphalt", x[kind == 1], y[kind == 1], z[kind == 1])
    n_air = max(n // 80, 4)
    emit(1, "soil", rng.uniform(0, E, n_air), rng.uniform(0, E, n_air),
         rng.uniform(2, 45, n_air))

    # ---- buildings (class 6 → background after remap): tree-height, low NDVI --
    n_bld = cnt["bld"]
    nb = int(rng.integers(2, 6))
    per_b = np.full(nb, n_bld // nb)
    per_b[-1] += n_bld - per_b.sum()
    for kb in range(nb):
        c = rng.uniform(-0.05, 1.05, 2) * E  # may straddle the tile edge
        w, d = rng.uniform(6, 16, 2)
        h = rng.uniform(3.0, 13.0)
        k = per_b[kb]
        k_roof = int(k * 0.7)
        rx = c[0] + rng.uniform(-w / 2, w / 2, k_roof)
        ry = c[1] + rng.uniform(-d / 2, d / 2, k_roof)
        emit(6, "roof", rx, ry, h + rng.normal(0, 0.15, k_roof))
        k_wall = k - k_roof
        side = rng.integers(0, 4, k_wall)
        wx = np.where(side < 2, c[0] + np.where(side == 0, -w / 2, w / 2),
                      c[0] + rng.uniform(-w / 2, w / 2, k_wall))
        wy = np.where(side < 2, c[1] + rng.uniform(-d / 2, d / 2, k_wall),
                      c[1] + np.where(side == 2, -d / 2, d / 2))
        emit(6, "roof", wx + rng.normal(0, 0.1, k_wall),
             wy + rng.normal(0, 0.1, k_wall), rng.uniform(0, h, k_wall))

    # ---- thin vertical poles: mini-pylon confusers, still background ----------
    n_pole = max(cnt["pole"], 0)
    if n_pole:
        npl = int(rng.integers(2, 6))
        per_p = np.full(npl, n_pole // npl)
        per_p[-1] += n_pole - per_p.sum()
        for kp in range(npl):
            c = rng.uniform(0, E, 2)
            h = rng.uniform(4.0, 11.0)
            k = per_p[kp]
            emit(1, "metal", c[0] + rng.normal(0, 0.15, k),
                 c[1] + rng.normal(0, 0.15, k), rng.uniform(0, h, k))

    # ---- low/medium vegetation: patches, dry/green mix, 0.3-6.5 m -------------
    n_low = cnt["low"]
    npatch = 10
    cx, cy = rng.uniform(0, E, npatch), rng.uniform(0, E, npatch)
    pr = rng.uniform(3, 9, npatch)
    which = rng.integers(0, npatch, n_low)
    lx = cx[which] + rng.normal(0, pr[which] / 2)
    ly = cy[which] + rng.normal(0, pr[which] / 2)
    lz = rng.gamma(1.6, 1.3, n_low).clip(0.25, 6.5)
    dry = rng.uniform(size=n_low) < 0.4
    low_cls = rng.choice([3, 4], n_low)
    for c in (3, 4):
        m = dry & (low_cls == c)
        emit(c, "drygrass", lx[m], ly[m], lz[m])
        m = ~dry & (low_cls == c)
        emit(c, "grass", lx[m], ly[m], lz[m])

    # ---- high vegetation: crown volumes 7-30 m, some hugging the corridor -----
    n_high = cnt["high"]
    ncr = int(rng.integers(8, 14))
    ccx, ccy = rng.uniform(-0.03, 1.03, ncr) * E, rng.uniform(-0.03, 1.03, ncr) * E
    ch = rng.uniform(7.0, 30.0, ncr)
    cr = np.minimum(rng.uniform(1.5, 6.0, ncr), ch * 0.4)
    if n_pylons > 0 and ncr >= 3:
        # plant the last 3 crowns within a few metres of the conductors, tops at
        # wire height — the lines-through-canopy failure mode
        t_c = rng.uniform(-span / 2, span / 2, 3)
        off = rng.uniform(2.0, 6.0, 3) * rng.choice([-1, 1], 3)
        near = mid[None, :] + t_c[:, None] * cdir[None, :] + off[:, None] * perp[None, :]
        ccx[-3:], ccy[-3:] = near[:, 0], near[:, 1]
        ch[-3:] = np.interp(t_c, t_py, py_h) - rng.uniform(-1.5, 3.0, 3)
    wc = rng.integers(0, ncr, n_high)
    u = rng.uniform(size=n_high)
    # crown volume: points concentrated in the upper 60 %, multi-return tail to 20 %
    hz = ch[wc] * np.where(u < 0.8, rng.uniform(0.45, 1.0, n_high),
                           rng.uniform(0.2, 0.5, n_high))
    rad = cr[wc] * np.sqrt(rng.uniform(size=n_high)) * (
        0.4 + 0.6 * np.sin(np.pi * np.clip(hz / np.maximum(ch[wc], 1e-6), 0, 1))
    )
    ang = rng.uniform(0, 2 * np.pi, n_high)
    emit(5, "canopy", ccx[wc] + rad * np.cos(ang), ccy[wc] + rad * np.sin(ang), hz)
    # under-canopy ground sees almost no returns — handled via hole/shadow noise

    # ---- pylons: lattice legs + cross-arms, sparse, sometimes edge-cut --------
    if n_pylons > 0:
        n_tw = cnt["tower"]
        per_t = np.full(len(t_py), n_tw // len(t_py))
        per_t[-1] += n_tw - per_t.sum()
        lean = rng.normal(0, 0.02, (len(t_py), 2))
        for i in range(len(t_py)):
            k = int(per_t[i])
            if k <= 0:
                continue
            zt = rng.uniform(0, py_h[i], k)
            frac_h = zt / py_h[i]
            spread = 2.4 * (1.0 - 0.8 * frac_h)
            leg = rng.integers(0, 4, k)
            legx = np.where(leg % 2 == 0, -1, 1) * spread
            legy = np.where(leg < 2, -1, 1) * spread
            tx = py_xy[i, 0] + legx + zt * lean[i, 0] + rng.normal(0, 0.25, k)
            ty = py_xy[i, 1] + legy + zt * lean[i, 1] + rng.normal(0, 0.25, k)
            # cross-arm: horizontal bar at the top, extends perpendicular — the
            # geometry a line-detector confuses with conductors
            arm = rng.uniform(size=k) < 0.18
            ext = rng.uniform(-4.5, 4.5, int(arm.sum()))
            tx[arm] = py_xy[i, 0] + ext * perp[0]
            ty[arm] = py_xy[i, 1] + ext * perp[1]
            zt[arm] = py_h[i] - np.abs(rng.normal(0, 0.6, int(arm.sum())))
            emit(15, "metal", tx, ty, zt)

        # ---- conductors: 2-3 wires + shield, catenary between pylons ----------
        n_ln = cnt["lines"]
        wires = int(rng.integers(2, 4))
        off_w = np.linspace(-1.8, 1.8, wires)
        per_w = np.full(wires + 1, n_ln // (wires + 1))
        per_w[-1] += n_ln - per_w.sum()
        for wi in range(wires + 1):
            k = int(per_w[wi])
            t = rng.uniform(t_py[0], t_py[-1], k)
            seg = np.clip(np.searchsorted(t_py, t) - 1, 0, len(t_py) - 2)
            t0, t1 = t_py[seg], t_py[seg + 1]
            h0, h1 = py_h[seg], py_h[seg + 1]
            s = (t - t0) / np.maximum(t1 - t0, 1e-6)
            sag = rng.uniform(2.0, 5.0)
            if wi < wires:  # conductor bundle: below the arm, offset sideways
                z = h0 + (h1 - h0) * s - 1.5 - sag * 4 * s * (1 - s)
                o = off_w[wi]
            else:  # shield wire: at the very top, less sag
                z = h0 + (h1 - h0) * s - 0.2 - 0.5 * sag * 4 * s * (1 - s)
                o = 0.0
            wx = mid[0] + t * cdir[0] + o * perp[0] + rng.normal(0, 0.12, k)
            wy = mid[1] + t * cdir[1] + o * perp[1] + rng.normal(0, 0.12, k)
            emit(14, "metal", wx, wy, z + rng.normal(0, 0.12, k))

    # ---- ground returns (class 2), thinned like everything else ---------------
    if with_ground:
        n_g = int(n_points * 0.3)
        emit(2, "soil", rng.uniform(0, E, n_g), rng.uniform(0, E, n_g),
             np.abs(rng.normal(0.03, 0.06, n_g)))

    pc = np.concatenate(parts, axis=0)
    pc = pc[rng.permutation(len(pc))]
    return pc[:n_points] if len(pc) > n_points else pc


def make_terrain(rng: np.random.Generator, relief_m: float, extent_m: float):
    """A smooth random heightmap ``f(x, y) -> z`` (sum of long-wavelength cosines)
    with total relief ≈ relief_m over the tile. The synth CLI adds it to raw z so
    the HAG stage (preproc/hag.py, replacing PDAL hag_nn) has real work to do."""
    k = 5
    wl = rng.uniform(0.4, 2.5, k) * extent_m
    ph = rng.uniform(0, 2 * np.pi, k)
    th = rng.uniform(0, np.pi, k)
    amp = rng.uniform(0.3, 1.0, k)
    amp = amp / amp.sum() * relief_m / 2

    def f(x, y):
        z = np.zeros_like(np.asarray(x, np.float64))
        for i in range(k):
            proj = (x * np.cos(th[i]) + y * np.sin(th[i])) * (2 * np.pi / wl[i])
            z = z + amp[i] * np.cos(proj + ph[i])
        return (z + relief_m / 2).astype(np.float64)

    return f


def synthetic_batch(
    rng: np.random.Generator,
    batch_size: int = 2,
    max_windows: int = 9,
    n_points: int = 128,
    num_features: int = 9,
    real_windows: Optional[int] = None,
) -> dict:
    """A padded model-ready batch dict (float32/int32) with replicate-padded windows,
    −1-padded labels, centroids — the shape contract of data/pipeline.py."""
    pts = np.zeros((batch_size, max_windows, n_points, num_features), np.float32)
    lbl = np.full((batch_size, max_windows, n_points), -1, np.int32)
    cent = np.zeros((batch_size, max_windows, 2), np.float32)
    for b in range(batch_size):
        w_real = real_windows or int(rng.integers(1, max_windows + 1))
        for w in range(max_windows):
            src = min(w, w_real - 1)  # replicate-pad from the last real window
            if w < w_real:
                scene = synthetic_scene(rng, n_points=n_points + 7)
                sel = rng.permutation(len(scene))[:n_points]
                window = scene[sel]
                feats = np.concatenate([window[:, 0:3], window[:, 4:10]], axis=1)
                feats[:, 0] = feats[:, 0] * 2 - 1
                feats[:, 1] = feats[:, 1] * 2 - 1
                if num_features > 9:
                    # stand-in extra (geom) columns: uniform in [0, 1], the
                    # range preproc/geomfeat.py guarantees
                    extra = rng.uniform(0, 1, (n_points, num_features - 9))
                    feats = np.concatenate([feats, extra.astype(np.float32)],
                                           axis=1)
                pts[b, w] = feats
                lbl[b, w] = remap_segmentation_labels(window[:, 3])
                cent[b, w] = feats[:, :2].mean(axis=0)
            else:
                pts[b, w] = pts[b, src]
                cent[b, w] = cent[b, src]
                # labels stay −1: padding windows are masked from loss and attention
    return {"points": pts, "labels": lbl, "centroids": cent}
