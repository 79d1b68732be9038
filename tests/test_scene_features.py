"""Extended scene graph: additional lights and multi-volume instances."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from ovr_tpu import api
from ovr_tpu.core.scene import (
    Camera,
    Light,
    StructuredVolume,
    TransferFunction,
    VolumeInstance,
    simple_scene,
)


def _cam():
    return Camera.create(from_=(0.5, 0.5, -2.2), at=(0.5, 0.5, 0.5),
                         fovy=50.0)


def _render(scene, shading="diffuse", w=40, h=32, rate=24.0):
    cfg = api.RenderConfig(width=w, height=h, spp=1, sampling_rate=rate,
                           shading=shading).resolved(scene)
    return api.render(scene, cfg)


class TestLights:
    def test_extra_directional_brightens(self, small_grid):
        scene = dataclasses.replace(simple_scene(small_grid), camera=_cam())
        base = _render(scene)
        lit = _render(dataclasses.replace(
            scene,
            lights=(Light.create(direction=(0.0, 0.0, -1.0),
                                 intensity=1.0),)))
        pm_b = np.asarray(base.rgba[..., :3] * base.rgba[..., 3:4])
        pm_l = np.asarray(lit.rgba[..., :3] * lit.rgba[..., 3:4])
        assert pm_l.sum() > pm_b.sum() * 1.05

    def test_point_light_falloff(self, small_grid):
        scene = dataclasses.replace(simple_scene(small_grid), camera=_cam())
        near = _render(dataclasses.replace(
            scene, lights=(Light.create(position=(0.5, 0.5, -0.2),
                                        kind="point"),)))
        far = _render(dataclasses.replace(
            scene, lights=(Light.create(position=(0.5, 0.5, -30.0),
                                        kind="point"),)))
        assert float(jnp.sum(near.rgba)) > float(jnp.sum(far.rgba))

    def test_ambient_light_ignored_by_marcher(self, small_grid):
        scene = dataclasses.replace(simple_scene(small_grid), camera=_cam())
        base = _render(scene)
        amb = _render(dataclasses.replace(
            scene, lights=(Light.create(kind="ambient", ambient=3.0),)))
        np.testing.assert_allclose(np.asarray(base.rgba),
                                   np.asarray(amb.rgba), atol=1e-6)

    def test_shearwarp_eligible_with_extra_lights(self, small_grid):
        """Extra lights no longer force the march: directional lights are
        extra cos-terms in the dense shade; point lights shade densely
        from plane coordinates (round-2 VERDICT Missing #2)."""
        scene = dataclasses.replace(
            simple_scene(small_grid), camera=_cam(),
            lights=(Light.create(direction=(0, 0, -1)),
                    Light.create(position=(0.5, 0.5, -0.3), kind="point")))
        cfg = api.RenderConfig(method="auto", shading="diffuse"
                               ).resolved(scene)
        assert cfg.sw is not None

    def test_shearwarp_extra_lights_parity(self, small_grid):
        """Shear-warp with 2 extra directional + 1 point light matches the
        march's extra-light shading (integrator._march_step)."""
        scene = dataclasses.replace(
            simple_scene(small_grid), camera=_cam(),
            lights=(Light.create(direction=(0.3, -0.2, -1.0),
                                 intensity=0.7),
                    Light.create(direction=(-1.0, 0.4, 0.1),
                                 intensity=0.5),
                    Light.create(position=(0.5, 1.8, 0.5), kind="point",
                                 intensity=1.2)))
        cfg_m = api.RenderConfig(width=48, height=40, sampling_rate=48.0,
                                 shading="diffuse").resolved(scene)
        cfg_s = dataclasses.replace(
            cfg_m, method="shearwarp").resolved(scene)
        fm = api.render(scene, cfg_m)
        fs = api.render(scene, cfg_s)
        pm = np.asarray(fm.rgba[..., :3] * fm.rgba[..., 3:4])
        ps = np.asarray(fs.rgba[..., :3] * fs.rgba[..., 3:4])
        am = np.asarray(fm.rgba[..., 3])
        ys, xs = np.nonzero(am > 0.01)
        interior = np.zeros_like(am, bool)
        interior[ys.min() + 2:ys.max() - 1, xs.min() + 2:xs.max() - 1] = True
        err = np.abs(pm - ps).max(-1)[interior]
        assert np.quantile(err, 0.95) < 0.08

    def test_shearwarp_extra_dir_lights_pallas_parity(self, small_grid):
        """The fused kernel's extra-light scalar slots (<= 4 directional)
        match the XLA shaded slice loop (interpret mode)."""
        scene = dataclasses.replace(
            simple_scene(small_grid), camera=_cam(),
            lights=(Light.create(direction=(0.3, -0.2, -1.0),
                                 intensity=0.7),
                    Light.create(direction=(-1.0, 0.4, 0.1),
                                 intensity=0.5)))
        cfg = api.RenderConfig(width=32, height=24, sampling_rate=16.0,
                               shading="diffuse",
                               method="shearwarp").resolved(scene)
        ref = api.render(scene, cfg)
        cfg_p = dataclasses.replace(
            cfg, sw=dataclasses.replace(cfg.sw, pallas=True, interpret=True))
        out = api.render(scene, cfg_p)
        np.testing.assert_allclose(np.asarray(out.rgba),
                                   np.asarray(ref.rgba), atol=5e-5)


class TestMultiVolume:
    def _two_volume_scene(self, small_grid):
        # primary in [0,1]^3; second, brighter box shifted +x, disjoint
        scene = simple_scene(small_grid)
        v2 = StructuredVolume.create(
            np.full((8, 8, 8), 0.9, np.float32),
            world_lo=(1.2, 0.0, 0.0), world_hi=(2.2, 1.0, 1.0))
        tf2 = TransferFunction.create(
            np.tile([[1.0, 0.1, 0.1]], (8, 1)), np.linspace(0, 1, 8),
            (0.0, 1.0))
        cam = Camera.create(from_=(1.1, 0.5, -3.2), at=(1.1, 0.5, 0.5),
                            fovy=45.0)
        return dataclasses.replace(
            scene, camera=cam,
            instances=(VolumeInstance.create(v2, tf2),))

    def test_both_volumes_visible(self, small_grid):
        scene = self._two_volume_scene(small_grid)
        f = _render(scene, shading="none", w=64, h=32, rate=16.0)
        a = np.asarray(f.rgba[..., 3])
        mid = a.shape[0] // 2
        cols = np.nonzero(a[mid] > 0.05)[0]
        assert len(cols) > 10, "volumes invisible"
        # two disjoint footprints separated by an empty gap
        gaps = np.diff(cols)
        assert gaps.max() >= 2, "expected two separated volumes"
        # the dense 0.9-valued instance shows as a red, high-alpha band
        dense = a[mid] > 0.85
        assert dense.any()
        rgb = np.asarray(f.rgba[mid][dense]).mean(0)
        assert rgb[0] > rgb[2]

    def test_disjoint_matches_single_renders(self, small_grid):
        """For disjoint boxes, multi-volume compositing must equal the sum
        of individually rendered volumes wherever only one is hit."""
        scene = self._two_volume_scene(small_grid)
        f_multi = _render(scene, shading="none", w=64, h=32, rate=16.0)
        f_single = _render(dataclasses.replace(scene, instances=()),
                           shading="none", w=64, h=32, rate=16.0)
        a_single = np.asarray(f_single.rgba[..., 3])
        mask = a_single > 0.01
        pm_m = np.asarray(f_multi.rgba[..., :3] * f_multi.rgba[..., 3:4])
        pm_s = np.asarray(f_single.rgba[..., :3] * f_single.rgba[..., 3:4])
        np.testing.assert_allclose(pm_m[mask], pm_s[mask], atol=1e-5)

    def test_depth_ordering(self, small_grid):
        """A nearer opaque instance occludes the primary volume."""
        scene = simple_scene(small_grid)
        blocker = StructuredVolume.create(
            np.ones((4, 4, 4), np.float32),
            world_lo=(0.0, 0.0, -1.0), world_hi=(1.0, 1.0, -0.5))
        tf2 = TransferFunction.create(
            np.tile([[0.0, 1.0, 0.0]], (4, 1)), np.ones(4), (0.0, 1.0))
        cam = Camera.create(from_=(0.5, 0.5, -3.0), at=(0.5, 0.5, 0.5))
        scene = dataclasses.replace(
            scene, camera=cam,
            instances=(VolumeInstance.create(blocker, tf2),))
        f = _render(scene, shading="none", w=24, h=24, rate=24.0)
        c = np.asarray(f.rgba)
        mid = c[12, 12]
        assert mid[1] > 0.9 and mid[0] < 0.1  # green blocker wins


class TestMultiVolumeShearwarp:
    def test_instances_resolve_per_volume_plans(self, small_grid):
        scene = TestMultiVolume._two_volume_scene(
            TestMultiVolume(), small_grid)
        cfg = api.RenderConfig(method="auto", shading="none",
                               width=64, height=32,
                               sampling_rate=16.0).resolved(scene)
        assert isinstance(cfg.sw, tuple) and len(cfg.sw) == 2

    @pytest.mark.parametrize("shading", ["none", "diffuse"])
    def test_instanced_shearwarp_matches_march(self, small_grid, shading):
        """Per-instance shear-warp + depth-ordered compositing matches
        the march's multivol path (disjoint boxes: parity to quadrature
        tolerance over the joint interior)."""
        scene = TestMultiVolume._two_volume_scene(
            TestMultiVolume(), small_grid)
        cfg_m = api.RenderConfig(method="march", shading=shading,
                                 width=64, height=32,
                                 sampling_rate=32.0).resolved(scene)
        cfg_s = api.RenderConfig(method="shearwarp", shading=shading,
                                 width=64, height=32,
                                 sampling_rate=32.0).resolved(scene)
        assert isinstance(cfg_s.sw, tuple)
        fm = api.render(scene, cfg_m)
        fs = api.render(scene, cfg_s)
        am = np.asarray(fm.rgba[..., 3])
        pm = np.asarray(fm.rgba[..., :3] * fm.rgba[..., 3:4])
        ps = np.asarray(fs.rgba[..., :3] * fs.rgba[..., 3:4])
        # erode the footprint (resampled silhouettes differ by ~1px)
        interior = am > 0.02
        interior[:2] = interior[-2:] = False
        interior[:, :2] = interior[:, -2:] = False
        from numpy.lib.stride_tricks import sliding_window_view as swv
        er = np.zeros_like(interior)
        er[1:-1, 1:-1] = swv(interior, (3, 3)).all((-1, -2))
        err = np.abs(pm - ps).max(-1)[er]
        assert err.size > 100
        assert np.quantile(err, 0.95) < 0.09, np.quantile(err, 0.95)

    def test_shadow_falls_back_to_march(self, small_grid):
        scene = TestMultiVolume._two_volume_scene(
            TestMultiVolume(), small_grid)
        cfg = api.RenderConfig(method="auto",
                               shading="shadow").resolved(scene)
        assert cfg.sw is None


class TestAffineVolumeInstances:
    """Affine volume placement (`ovr/scene.h:324-327`,
    `ovr/devices/optix7/volume.cpp:25-40`): VolumeInstance.xfm."""

    def _inst_scene(self, small_grid, xfm, camera, light_dir):
        # transparent primary (contributes nothing); one visible instance
        prim = StructuredVolume.create(np.zeros((4, 4, 4), np.float32),
                                       world_lo=(-9, -9, -9),
                                       world_hi=(-8, -8, -8))
        tf0 = TransferFunction.create(np.zeros((4, 3), np.float32),
                                      np.zeros(4, np.float32), (0.0, 1.0))
        v = StructuredVolume.create(np.asarray(small_grid, np.float32))
        tf = TransferFunction.create(
            np.stack([np.linspace(0, 1, 8), 0.4 * np.ones(8),
                      np.linspace(1, 0, 8)], -1),
            np.linspace(0.0, 0.9, 8), (0.0, 1.0))
        scene = simple_scene(np.zeros((4, 4, 4), np.float32))
        scene = dataclasses.replace(
            scene, volume=prim, tfn=tf0, camera=camera,
            light=dataclasses.replace(scene.light,
                                      direction=jnp.asarray(
                                          light_dir, jnp.float32)),
            instances=(VolumeInstance.create(v, tf, xfm=xfm),))
        return scene

    @staticmethod
    def _rot(theta, c=(0.5, 0.5, 0.5)):
        """(3,4) rotation about the z axis through point c."""
        ct, st = np.cos(theta), np.sin(theta)
        r = np.array([[ct, -st, 0.0], [st, ct, 0.0], [0.0, 0.0, 1.0]],
                     np.float32)
        c = np.asarray(c, np.float32)
        t = c - r @ c
        return np.concatenate([r, t[:, None]], axis=1)

    def test_identity_xfm_matches_no_xfm(self, small_grid):
        cam = _cam()
        eye = np.concatenate([np.eye(3, dtype=np.float32),
                              np.zeros((3, 1), np.float32)], 1)
        a = _render(self._inst_scene(small_grid, eye, cam, (1, 1, -1)))
        b = _render(self._inst_scene(small_grid, None, cam, (1, 1, -1)))
        np.testing.assert_allclose(np.asarray(a.rgba), np.asarray(b.rgba),
                                   atol=1e-5)

    def test_rotated_instance_equals_rotated_world(self, small_grid):
        """Rotating the instance == inverse-rotating camera + light (the
        whole-world rotation identity); exact for rotations."""
        th = 0.7
        xfm = self._rot(th)
        r = xfm[:, :3]
        cam_a = _cam()
        a = _render(self._inst_scene(small_grid, xfm, cam_a, (1, 1, -1)),
                    shading="diffuse", w=48, h=40, rate=32.0)

        c = np.array([0.5, 0.5, 0.5], np.float32)
        rinv = r.T

        def rot_pt(p):
            return rinv @ (np.asarray(p, np.float32) - c) + c

        cam_b = Camera.create(from_=rot_pt(cam_a.from_),
                              at=rot_pt(cam_a.at),
                              up=rinv @ np.asarray([0, 1, 0], np.float32),
                              fovy=50.0)
        ld = rinv @ np.asarray([1, 1, -1], np.float32)
        b = _render(self._inst_scene(small_grid, None, cam_b, tuple(ld)),
                    shading="diffuse", w=48, h=40, rate=32.0)
        np.testing.assert_allclose(np.asarray(a.rgba), np.asarray(b.rgba),
                                   atol=2e-3)
        np.testing.assert_allclose(np.asarray(a.grad), np.asarray(b.grad),
                                   atol=2e-3)

    def test_translated_instance_matches_moved_box(self, small_grid):
        t = np.array([0.3, -0.2, 0.1], np.float32)
        xfm = np.concatenate([np.eye(3, dtype=np.float32), t[:, None]], 1)
        cam = Camera.create(from_=(0.8, 0.3, -2.4), at=(0.8, 0.3, 0.6),
                            fovy=50.0)
        a = _render(self._inst_scene(small_grid, xfm, cam, (1, 1, -1)))
        sc_b = self._inst_scene(small_grid, None, cam, (1, 1, -1))
        inst = sc_b.instances[0]
        vol_b = dataclasses.replace(inst.volume,
                                    world_lo=inst.volume.world_lo + t,
                                    world_hi=inst.volume.world_hi + t)
        sc_b = dataclasses.replace(
            sc_b, instances=(dataclasses.replace(inst, volume=vol_b),))
        b = _render(sc_b)
        np.testing.assert_allclose(np.asarray(a.rgba), np.asarray(b.rgba),
                                   atol=1e-4)
