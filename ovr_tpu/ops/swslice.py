"""Fused shear-warp slice loop as one Pallas kernel on the Triton route.

The XLA version of the slice loop (render.shearwarp) writes its compositing
carry (color / gradient / depth / transmittance over the intermediate ray
fan) to device memory every slice and resamples each plane with two
hat-matrix matmuls. This kernel runs the whole loop inside one GPU block,
in the way the reference marches one thread per ray
(`ovr/devices/optix7/shaders_raymarching.cu:87-171`):

  grid = (fan row blocks, fan column blocks)   # independent blocks
  per block: a (BR, BC) tile of fan rays; the block's slice schedule runs
  as a counted loop with the carry held in registers.
  per slice: trilinear gather of the volume at the plane's sample points
  (8 taps, read in the volume's own dtype), two-tap TF table gather,
  opacity correction from the exact per-pixel ray/box interval (computed
  by XLA before the call, so clip boxes and geometry hits need no kernel
  code), front-to-back over compositing.

Data-dependent work avoidance (the reference's two defining optimizations):

  * Macrocell empty-slice skipping (`accel/spatial_partition.h:56-96`,
    `accel/dda.h:30-148`): XLA reduces the macrocell majorants to a
    per-(block, slice) activity bit (`active_blocks`) and compacts the
    active slice indices into one schedule row per block
    (`compact_schedule`). Each block loads its own row and count.
  * Early ray termination (`shaders_raymarching.cu:110`, alpha >= 0.9999):
    after each slice a block-wide test asks whether some ray is still
    unsaturated and has its box exit ahead of the current plane; once none
    is, the remaining steps skip the slice body.

Shading modes (static):
  0 none     — emission-absorption only
  1 diffuse  — gradient shading; the lateral gradient is the forward
               difference of the trilinear field over one voxel (the
               reference's stencil; the XLA loop's `fd_grad=False`), the
               axial one comes from the along-ray difference of
               consecutive planes
  2 shadow   — diffuse + shadow from the light-transmittance lattice,
               gathered like the volume

Native-dtype residency (`array.h:68-106`): the volume is read as float32,
bfloat16, uint8 or uint16; integer samples are scaled by 1/int_max.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ovr_tpu.core.sampling import storage_scale

# fan rows x fan columns per block (powers of two) and warps per block:
# fastest of (32,32)/4, (32,32)/8, (16,64)/4, (64,32)/8 on an H100 (PERF.md)
BLOCK = (32, 32)
NUM_WARPS = 4
MC = 16  # macrocell edge in voxels (accel.MACROCELL_SIZE)
T_EPS = 1e-4  # termination transmittance (alpha >= 0.9999)
N_EXTRA_MAX = 4  # extra directional lights the kernel shades

# Scalar vector layout. lo*/ex* are the SAMPLE box (voxel texel mapping);
# smp0/smpsc map traversal depth z_rel to the local grid's axial texel
# coordinate (c = (z_rel - smp0) * smpsc - 0.5); g* is the global box the
# shadow lattice spans. They differ only on the bricked path
# (parallel.bricks). `off` folds the slice-subrange offset (slice0 +
# jitter); `gs` is the normalized-integer storage scale.
_NAMES = (
    "lo1", "ex1", "lo2", "ex2", "ew1", "ew2", "dw1", "dw2", "half", "dz",
    "off", "vlo", "vscale", "base", "lam0", "dlam", "exa", "ld1",
    "ld2", "lda", "k1o", "k2o", "invda", "dzdlam",
    "w00", "w01", "w02", "w10", "w11", "w12", "w20", "w21", "w22",
    "smp0", "smpsc", "glo1", "gex1", "glo2", "gex2", "gs",
) + tuple(f"el{i}_{c}" for i in range(N_EXTRA_MAX) for c in range(4))
S = {name: i for i, name in enumerate(_NAMES)}
N_SCALARS = 64
assert len(_NAMES) <= N_SCALARS


def pack_scalars(dt, **vals):
    """Stack named kernel scalars into the (N_SCALARS,) vector; absent
    names are zero. Extra directional light i fills el{i}_0..3 =
    (d_w1, d_w2, d_axis, intensity)."""
    unknown = set(vals) - set(S)
    assert not unknown, unknown
    z = jnp.zeros((), dt)
    out = [jnp.asarray(vals.get(n, z), dt) for n in _NAMES]
    out += [z] * (N_SCALARS - len(out))
    return jnp.stack(out)


def _kernel(sc_ref, pg_ref, qg_ref, lin_ref, lout_ref, spd_ref, tab_ref,
            vol_ref, lg_ref, jf_ref, na_ref, out_ref, *, dims, n_tab,
            lg_dims, mode, ortho, n_extra, term, skip, n_slices, n_cb):
    """One (BR, BC) block of fan rays: run its slice schedule front to back
    and write the (8, BR, BC) block [c_r, c_g, c_b, g_x, g_y, g_z, depth,
    alpha]."""
    f32, i32 = jnp.float32, jnp.int32
    n_a, n_r, n_c = dims
    b = pl.program_id(0) * n_cb + pl.program_id(1)

    def s(name):
        return sc_ref[S[name]]

    pg = pg_ref[...][None, :]  # (1, BC) fan p coordinates
    qg = qg_ref[...][:, None]  # (BR, 1) fan q coordinates
    l_in = lin_ref[...]
    l_out = lout_ref[...]
    speed = spd_ref[...]
    shape = l_in.shape

    def bilerp_idx(pos, n):
        """Clamp-addressed linear taps: (i0, i0 + 1, frac)."""
        p = jnp.clip(pos, 0.0, n - 1.0)
        i0f = jnp.minimum(jnp.floor(p), n - 2.0)
        return i0f.astype(i32), p - i0f

    def taps(ref, k, fz, r0, c0):
        """z-lerped corners (r0|r1) x (c0|c1) of slab pair (k, k + 1)."""
        r0b = jnp.broadcast_to(r0, shape)
        c0b = jnp.broadcast_to(c0, shape)

        def zl(rr, cc):
            lo = ref[k, rr, cc].astype(f32)
            hi = ref[k + 1, rr, cc].astype(f32)
            return lo * (1.0 - fz) + hi * fz

        return (zl(r0b, c0b), zl(r0b, c0b + 1), zl(r0b + 1, c0b),
                zl(r0b + 1, c0b + 1))

    def trilinear(ref, k, fz, vr, vc, n_rr, n_cc):
        """Clamp-addressed trilinear sample at (slab pair k, row vr, col
        vc) — `core.sampling.sample_volume` in fan coordinates."""
        r0, fr = bilerp_idx(vr, n_rr)
        c0, fc = bilerp_idx(vc, n_cc)
        p00, p01, p10, p11 = taps(ref, k, fz, r0, c0)
        return ((p00 * (1.0 - fc) + p01 * fc) * (1.0 - fr)
                + (p10 * (1.0 - fc) + p11 * fc) * fr)

    # loop state: ([alive (int32),] *carry). Every carried value is
    # computed in the body — the Triton lowering cannot yield a constant
    n_head = 1 if term else 0

    def body(j, st):
        """Slice step j of the block's schedule."""
        gs = s("gs")
        acc = list(st[n_head:])
        js = jf_ref[b, j] if skip else j
        z_rel = (js.astype(f32) + s("off")) * s("dz")
        lam = z_rel * s("dlam") + s("lam0")
        c = jnp.clip((z_rel - s("smp0")) * s("smpsc") - 0.5, 0.0, n_a - 1.0)
        kf = jnp.clip(jnp.floor(c), 0.0, n_a - 2.0)
        fz = c - kf
        if ortho:
            x1 = pg + s("dw1") * lam
            x2 = qg + s("dw2") * lam
        else:
            x1 = s("ew1") + pg * lam
            x2 = s("ew2") + qg * lam
        vc = (x1 - s("lo1")) / s("ex1") * n_c - 0.5
        vr = (x2 - s("lo2")) / s("ex2") * n_r - 0.5
        k = kf.astype(i32)
        smp = trilinear(vol_ref, k, fz, vr, vc, n_r, n_c) * gs

        # TF classification: two-tap nodal lookup (shaders_common.h:356-367)
        v = jnp.clip((smp - s("vlo")) * s("vscale"), 0.0, 1.0)
        cv = v * (n_tab - 1)
        i0f = jnp.clip(jnp.floor(cv), 0.0, n_tab - 1.0)
        f = cv - i0f
        i0 = i0f.astype(i32)
        i1 = jnp.minimum(i0 + 1, n_tab - 1)

        def lut(ch):
            return tab_ref[ch, i0] * (1.0 - f) + tab_ref[ch, i1] * f

        rgb = [jnp.clip(lut(ch), 0.0, 1.0) for ch in range(3)]
        a_raw = lut(3)

        # opacity correction 1 - (1-a)^(base*dt) over the plane's exact
        # ray-interval overlap (shaders_raymarching.cu:117-122)
        seg_lo = jnp.maximum(lam - s("half"), l_in)
        seg_hi = jnp.minimum(lam + s("half"), l_out)
        dt_w = jnp.maximum(seg_hi - seg_lo, 0.0) * speed
        kk = s("base") * dt_w
        a_c = jnp.clip(a_raw, 0.0, 1.0 - 1e-7)
        a = jnp.clip(1.0 - jnp.exp(kk * jnp.log1p(-a_c)), 0.0, 1.0)
        a = jnp.where(jnp.abs(kk - 1.0) < 1e-7, jnp.clip(a_raw, 0.0, 1.0), a)
        a = jnp.where(dt_w > 0.0, a, 0.0)
        a = jnp.minimum(a, 1.0 - 1e-6)  # over_scan's A_MAX

        trans = acc[4]
        aw = trans * a
        if mode >= 1:
            # lateral gradient: forward difference of the trilinear field
            # over one voxel, backward at the upper face — the reference's
            # stencil (shaders_common.h:195-215, core.sampling.gradient_of)
            s1 = jnp.where(vc > n_c - 1.5, -1.0, 1.0)
            s2 = jnp.where(vr > n_r - 1.5, -1.0, 1.0)
            g1 = ((trilinear(vol_ref, k, fz, vr, vc + s1, n_r, n_c) * gs
                   - smp) * s1 * (n_c / s("ex1")))
            g2 = ((trilinear(vol_ref, k, fz, vr + s2, vc, n_r, n_c) * gs
                   - smp) * s2 * (n_r / s("ex2")))
            prev = acc[8]
            ds = jnp.where(j > 0, (smp - prev) / s("dzdlam"), 0.0)
            k1 = s("k1o") if ortho else pg
            k2 = s("k2o") if ortho else qg
            ga = (ds - g1 * k1 - g2 * k2) * s("invda")
            n1, n2, na = -g1, -g2, -ga
            inv = jax.lax.rsqrt(n1 * n1 + n2 * n2 + na * na + 1e-12)
            total = jnp.abs(s("ld1") * n1 + s("ld2") * n2
                            + s("lda") * na) * inv
            for i in range(n_extra):
                ce = jnp.abs(s(f"el{i}_0") * n1 + s(f"el{i}_1") * n2
                             + s(f"el{i}_2") * na) * inv
                total = total + 0.5 * ce * s(f"el{i}_3")
            if mode == 2:
                l_a, l_r, l_c = lg_dims
                cl = jnp.clip(z_rel / s("exa") * l_a - 0.5, 0.0, l_a - 1.0)
                klf = jnp.clip(jnp.floor(cl), 0.0, l_a - 2.0)
                # the lattice spans the GLOBAL box (bricks sample a local one)
                sh = trilinear(
                    lg_ref, klf.astype(i32), cl - klf,
                    (x2 - s("glo2")) / s("gex2") * l_r - 0.5,
                    (x1 - s("glo1")) / s("gex1") * l_c - 0.5, l_r, l_c)
                total = total * (1.0 - jnp.clip(sh, 0.0, 1.0))
            shade = 0.5 + total
            rgb = [jnp.clip(x * shade, 0.0, 1.0) for x in rgb]
            nu = (n1 * inv, n2 * inv, na * inv)
            for ax in range(3):
                ncam = jnp.clip(s(f"w{ax}0") * nu[0] + s(f"w{ax}1") * nu[1]
                                + s(f"w{ax}2") * nu[2], 0.0, 1.0)
                acc[5 + ax] = acc[5 + ax] + aw * ncam
            acc[8] = smp
        for ch in range(3):
            acc[ch] = acc[ch] + aw * rgb[ch]
        acc[3] = acc[3] + aw * (lam * speed)
        acc[4] = trans * (1.0 - a)
        if not term:
            return tuple(acc)
        # a ray still matters while unsaturated AND its box exit lies
        # ahead of both this (front-to-back) plane and its box entry
        live = (acc[4] > T_EPS) & (l_out > jnp.maximum(lam, l_in))
        return (jnp.max(live.astype(i32)), *acc)

    # The schedule runs as a counted loop (scf.for); once no ray of the
    # block can contribute, the remaining steps skip the slice body. (A
    # while loop whose condition reads the block-wide reduction is the
    # natural form, but Triton's GPU compiler crashes on it.)
    def step(j, st):
        if not term:
            return body(j, st)
        return jax.lax.cond(st[0] > 0, body, lambda _, t: t, j, st)

    zero = jnp.zeros(shape, f32)
    acc0 = [zero] * 4 + [jnp.ones(shape, f32)]
    if mode >= 1:
        acc0 += [zero] * 4
    head = (jnp.int32(1),) if term else ()
    n_act = na_ref[b] if skip else n_slices
    st = jax.lax.fori_loop(0, n_act, step, (*head, *acc0))
    acc = st[n_head:]
    for ch in range(3):
        out_ref[ch, :, :] = acc[ch]
    for ax in range(3):
        out_ref[3 + ax, :, :] = acc[5 + ax] if mode >= 1 else zero
    out_ref[6, :, :] = acc[3]
    out_ref[7, :, :] = 1.0 - acc[4]


def _traversal_cell(k, n, sign):
    """Traversal-ordered macrocell index of traversal-ordered voxel k along
    an axis of n voxels (the view reverses the axis when sign < 0)."""
    if sign > 0:
        return k // MC
    return -(-n // MC) - 1 - (n - 1 - k) // MC


def active_blocks(maj_v, scalars, pg_p, qg_p, n_slices, dims, block, mode,
                  ortho, sign, eps=1.19e-7):
    """Per-(block, slice) activity (n_blocks, n_slices) bool from the
    traversal-ordered macrocell majorant grid maj_v (MA, MR, MC): is any
    majorant > eps inside the voxel footprint of the block's rays on the
    slice's slab pair?

    Semantics match the reference's DDA skip (`accel/spatial_partition.h:
    56-96`): a slice whose covering macrocells all have zero majorant
    classifies to zero opacity for every ray of the block, so skipping it
    is exact. Footprints are rectangles (sample coordinates are monotone in
    the fan coordinates for a fixed slice), counted with a summed-area
    table. Mode >= 1 also keeps each active slice's predecessor, whose
    sample feeds the next plane's along-ray derivative."""
    n_a, n_r, n_c = dims
    br, bc = block
    sc = scalars
    occ = maj_v > eps
    # slab pair (k, k+1) can straddle two axial cells
    occ = occ | jnp.concatenate([occ[1:], occ[-1:]], axis=0)
    sat = jnp.cumsum(jnp.cumsum(occ.astype(jnp.int32), axis=1), axis=2)
    sat = jnp.pad(sat, ((0, 0), (1, 0), (1, 0)))  # (MA, MR + 1, MC + 1)
    ma, mr1, mc1 = sat.shape

    jf = jnp.arange(n_slices, dtype=jnp.float32)
    z_rel = (jf + sc[S["off"]]) * sc[S["dz"]]
    lam = z_rel * sc[S["dlam"]] + sc[S["lam0"]]
    c = jnp.clip((z_rel - sc[S["smp0"]]) * sc[S["smpsc"]] - 0.5, 0.0,
                 n_a - 1.0)
    k0 = jnp.clip(jnp.floor(c), 0.0, n_a - 2.0).astype(jnp.int32)
    a_cell = jnp.clip(_traversal_cell(k0, n_a, sign), 0, ma - 1)  # (S,)

    def cells(g, bsz, e, d, lo, ex, n):
        """(n_blocks_axis, S) first/last macrocell the block's taps read."""
        ends = g.reshape(-1, bsz)[:, (0, -1)]  # (NB, 2)
        if ortho:
            x = ends[:, :, None] + d * lam
        else:
            x = e + ends[:, :, None] * lam
        pos = jnp.clip((x - lo) / ex * n - 0.5, 0.0, n - 1.0)
        v_lo = jnp.floor(pos.min(axis=1)).astype(jnp.int32)
        v_hi = jnp.minimum(jnp.floor(pos.max(axis=1)).astype(jnp.int32) + 1,
                           n - 1)
        return v_lo // MC, v_hi // MC

    rl, rh = cells(qg_p, br, sc[S["ew2"]], sc[S["dw2"]], sc[S["lo2"]],
                   sc[S["ex2"]], n_r)
    cl, ch = cells(pg_p, bc, sc[S["ew1"]], sc[S["dw1"]], sc[S["lo1"]],
                   sc[S["ex1"]], n_c)
    flat = sat.reshape(-1)
    a = a_cell[None, None, :]
    rl, rh = rl[:, None, :], rh[:, None, :] + 1
    cl, ch = cl[None, :, :], ch[None, :, :] + 1

    def at(r, cc):
        return jnp.take(flat, (a * mr1 + r) * mc1 + cc)

    count = at(rh, ch) - at(rl, ch) - at(rh, cl) + at(rl, cl)
    active = (count > 0).reshape(-1, n_slices)
    if mode >= 1:
        nxt = jnp.concatenate(
            [active[:, 1:], jnp.zeros_like(active[:, :1])], 1)
        active = active | nxt
    return active


def compact_schedule(active):
    """Compact a (B, S) activity mask into (jf (B, S) int32, n_act (B,)):
    ascending active slice indices first, then the last active index
    repeated."""
    t, s = active.shape
    order = jnp.argsort(jnp.logical_not(active).astype(jnp.int32), axis=1,
                        stable=True)  # (B, S) active indices first, sorted
    n_act = active.sum(axis=1).astype(jnp.int32)  # (B,)
    last = jnp.take_along_axis(
        order, jnp.maximum(n_act - 1, 0)[:, None], axis=1)  # (B, 1)
    pos = jax.lax.broadcasted_iota(jnp.int32, (t, s), 1)
    jf = jnp.where(pos < n_act[:, None], order, last)
    return jf.astype(jnp.int32), n_act


def _pad_lattice(g, pad):
    """Continue a uniform 1D lattice by `pad` entries."""
    if not pad:
        return g
    d = g[1] - g[0] if g.shape[0] > 1 else jnp.ones((), g.dtype)
    return jnp.concatenate(
        [g, g[-1] + d * jnp.arange(1, pad + 1, dtype=g.dtype)])


def slice_composite(grid_v, rgba_tab, scalars, pg, qg, l_in, l_out, speed,
                    n_slices: int, *, mode: int = 0, ortho: bool = False,
                    sign: int = 1, lgrid=None, n_extra: int = 0,
                    majorant_v=None, term: bool = True,
                    interpret: bool = False):
    """Run the fused slice loop.

    grid_v (A, Nr, Nc): traversal-ordered volume (float32, bfloat16, uint8
    or uint16 — read in its own dtype); rgba_tab (K, 4) merged nodal TF
    table; scalars (N_SCALARS,) (`pack_scalars`); pg (Wi,), qg (Hi,) fan
    lattices; l_in / l_out / speed (Hi, Wi) each fan ray's clipped box
    interval and |d| per unit ray parameter. mode 0/1/2 = none/diffuse/
    shadow; lgrid (La, Lr, Lc) traversal-ordered shadow lattice for mode 2.
    `majorant_v` (MA, MR, MC): traversal-ordered macrocell majorants
    enabling per-block empty-slice skipping (`sign` is the traversal sign
    of the principal axis); `term` enables early ray termination.
    `interpret` runs the kernel in the Pallas interpreter (tests on the
    CPU); the card always runs it compiled. Blocks are BLOCK rays with
    NUM_WARPS warps each.
    Returns (8, Hi, Wi): premultiplied r, g, b, grad_cam xyz, depth, alpha.
    """
    n_a, n_r, n_c = grid_v.shape
    hi_i, wi_i = qg.shape[0], pg.shape[0]
    br, bc = BLOCK
    pad_h, pad_w = (-hi_i) % br, (-wi_i) % bc
    n_rb, n_cb = (hi_i + pad_h) // br, (wi_i + pad_w) // bc
    f32 = jnp.float32
    # padding CONTINUES the fan lattice; pad rays get an empty box
    # interval, so they composite nothing and never hold a block alive
    pg_p = _pad_lattice(pg.astype(f32), pad_w)
    qg_p = _pad_lattice(qg.astype(f32), pad_h)
    pad2 = ((0, pad_h), (0, pad_w))
    lin_p = jnp.pad(l_in.astype(f32), pad2)
    lout_p = jnp.pad(l_out.astype(f32), pad2)
    spd_p = jnp.pad(speed.astype(f32), pad2, constant_values=1.0)
    tab = rgba_tab.astype(f32).T  # (4, K)
    sc = scalars.astype(f32).at[S["gs"]].set(storage_scale(grid_v.dtype))

    if lgrid is None or mode != 2:
        lgrid = jnp.zeros((2, 2, 2), f32)
    lgrid = lgrid.astype(f32)

    skip = majorant_v is not None
    if skip:
        active = active_blocks(majorant_v, sc, pg_p, qg_p, n_slices,
                               (n_a, n_r, n_c), BLOCK, mode, ortho, sign)
        jfc, n_act = compact_schedule(active)
    else:
        jfc = jnp.zeros((1, 1), jnp.int32)
        n_act = jnp.zeros((1,), jnp.int32)

    kernel = functools.partial(
        _kernel, dims=(n_a, n_r, n_c), n_tab=tab.shape[1],
        lg_dims=lgrid.shape, mode=mode, ortho=bool(ortho),
        n_extra=int(n_extra), term=bool(term), skip=skip,
        n_slices=int(n_slices), n_cb=n_cb)
    whole = pl.BlockSpec()
    tile = pl.BlockSpec((br, bc), lambda i, j: (i, j))
    out = pl.pallas_call(
        kernel,
        grid=(n_rb, n_cb),
        in_specs=[
            whole,  # scalars
            pl.BlockSpec((bc,), lambda i, j: (j,)),  # pg
            pl.BlockSpec((br,), lambda i, j: (i,)),  # qg
            tile, tile, tile,  # l_in, l_out, speed
            whole, whole, whole,  # TF table, volume, shadow lattice
            whole, whole,  # compacted schedule, active counts
        ],
        out_specs=pl.BlockSpec((8, br, bc), lambda i, j: (0, i, j)),
        out_shape=jax.ShapeDtypeStruct((8, n_rb * br, n_cb * bc), f32),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="sw_slice_composite",
    )(sc, pg_p, qg_p, lin_p, lout_p, spd_p, tab, grid_v, lgrid, jfc, n_act)
    return out[:, :hi_i, :wi_i]
