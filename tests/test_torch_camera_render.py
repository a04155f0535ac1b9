"""PyTorch port: renders through the camera models against the JAX
package's "xla" route: a distorted pinhole in UT mode, an ortho camera (EWA)
and a rolling-shutter fisheye through a pose delta. The body and its
tolerances are in tests/torch_camera_cases.py; the "pallas" route's case is
in tests/test_torch_camera_render_pallas.py.
"""

import pytest

from torch_camera_cases import check_render


@pytest.mark.parametrize("kind,impl", [("distorted-ut", "xla"), ("ortho", "xla"),
                                       ("rolling-fisheye", "xla")])
def test_render_matches_jax(kind, impl):
    check_render(kind, impl)
