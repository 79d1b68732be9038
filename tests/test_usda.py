"""USDA settings-overlay reader (io.usda; serializer_usda.cpp subset)."""

import base64
import json
import os

import numpy as np
import pytest

from ovr_tpu.io import usda, vidi3d


USDA_DOC = """#usda 1.0

def "scene" {
    def "rendering" {
        int use_dda = 2 # multi-layer DDA
        bool parallel_view = False
        bool simple_path_tracing = True
    }
    def "volume" {
        # string data_path = "ignored.json"
        string data_path = "base.json"
    }
    def "camera" {
        float3 from = (
            -10.0,
            20.5, -15.25
        )
        float3 at = (4, 4, 4)
        float3 up = (0, 1, 0)
    }
    def "light" {
        def "ambient" {
            def "first_light" {
                float  intensity = 0.25
                float3 color     = (1, 1, 1)
            }
        }
        def "directional" {
            def "first_light" {
                float  intensity = 2
                float3 direction = (0, -10, 0)
                float3 color     = (1, 0.5, 0.25)
            }
        }
    }
}
"""


def test_parse_usda_structure():
    doc = usda.parse_usda(USDA_DOC)
    sc = doc["scene"]
    assert sc["rendering"]["use_dda"] == 2
    assert sc["rendering"]["parallel_view"] is False
    assert sc["rendering"]["simple_path_tracing"] is True
    assert sc["volume"]["data_path"] == "base.json"
    assert sc["camera"]["from"] == (-10.0, 20.5, -15.25)
    assert sc["light"]["directional"]["first_light"]["color"] == \
        (1.0, 0.5, 0.25)


@pytest.fixture
def base_scene_json(tmp_path, rng):
    vol = rng.uniform(size=(8, 8, 8)).astype("<f4")
    vol.tofile(tmp_path / "v.raw")
    alpha = np.linspace(0, 1, 16).astype("<f4")
    js = {
        "version": "VIDI3D",
        "dataSource": [{
            "format": "REGULAR_GRID_RAW_BINARY",
            "fileName": ["v.raw"],
            "dimensions": {"x": 8, "y": 8, "z": 8},
            "type": "FLOAT", "offset": 0, "endian": "LITTLE_ENDIAN",
        }],
        "view": {
            "camera": {"eye": {"x": 4, "y": 4, "z": -20},
                       "center": {"x": 4, "y": 4, "z": 4},
                       "up": {"x": 0, "y": 1, "z": 0}, "fovy": 45},
            "volume": {
                "scalarMappingRange": {"minimum": 0.0, "maximum": 1.0},
                "transferFunction": {
                    "alphaArray": {
                        "encoding": "BASE64",
                        "data": base64.b64encode(alpha.tobytes()).decode(),
                    },
                    "colorControls": [
                        {"position": 0, "color": {"r": 0, "g": 0, "b": 1}},
                        {"position": 1, "color": {"r": 1, "g": 0, "b": 0}},
                    ],
                },
            },
        },
    }
    (tmp_path / "base.json").write_text(json.dumps(js))
    return tmp_path


def test_create_scene_usda_overrides(base_scene_json):
    path = base_scene_json / "scene.usda"
    path.write_text(USDA_DOC)
    scene, rendering = usda.create_scene_usda(str(path))
    assert rendering["use_dda"] == 2
    np.testing.assert_allclose(np.asarray(scene.camera.from_),
                               [-10.0, 20.5, -15.25])
    np.testing.assert_allclose(np.asarray(scene.camera.at), [4, 4, 4])
    # directional override: points toward the light, intensity-scaled color
    np.testing.assert_allclose(np.asarray(scene.light.direction),
                               [0.0, 10.0, 0.0])
    np.testing.assert_allclose(np.asarray(scene.light.color),
                               [2.0, 1.0, 0.5])
    np.testing.assert_allclose(float(scene.light.ambient), 0.25)
    assert scene.volume.grid.shape == (8, 8, 8)


def test_dispatch_by_extension(base_scene_json):
    path = base_scene_json / "scene.usda"
    path.write_text(USDA_DOC)
    scene = vidi3d.create_scene(str(path))
    assert scene.volume.grid.shape == (8, 8, 8)


def test_reference_settings_file_parses():
    """The reference's own data/scene_setting.usda structure round-trips
    (needs a checkout of the reference, named by OVR_REFERENCE_DIR)."""
    ref = os.environ.get("OVR_REFERENCE_DIR", "")
    path = os.path.join(ref, "data", "scene_setting.usda")
    if not ref or not os.path.exists(path):
        pytest.skip("reference checkout absent (set OVR_REFERENCE_DIR)")
    with open(path) as f:
        doc = usda.parse_usda(f.read())
    sc = doc["scene"]
    assert sc["rendering"]["use_dda"] == 2
    assert "data_path" in sc["volume"]
    assert len(sc["camera"]["from"]) == 3
