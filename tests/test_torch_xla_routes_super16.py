"""render.render(..., max_table_mb=0) against gdpt_tpu under
GDPT_PACKET=1 GDPT_MAX_TABLE_MB=0.

With a cap of 0 MiB no packet table fits: the reference builds its
super16 table for a scene of more than 128 primitives and walks it
(traverse_soa.py:145-158, :579-588), as the port does with
max_table_mb=0 for every BVH scene. The scenes of
tests/test_torch_xla_routes.py (the force_bvh Cornell box `path` and
`gradpath`, the medium box `volpath`; the material box `path`, with its
nine spheres in the table, is in test_torch_xla_routes_super16_spheres.py)
and the Cornell walls around a 320-triangle icosphere `path`, at the same
gates: the path slice's for every buffer (gradpath's gradients within
0.1% of the primal's mean) and ray counts within 0.1%. The Cornell box
holds 36 primitives, too few for the reference to build a packet or
super16 table even under GDPT_PACKET=1: there it takes its packed walk,
and the port's super16 walk is held to that.
"""

import pytest

from test_torch_packet import one_thread  # noqa: F401 (autouse fixture)
from test_torch_xla_routes import build, check_route, port_render, reference_render

_CACHE = {}
NAMES = ["cbox_path", "cbox_gradpath", "medium_volpath", "icosphere_path"]


@pytest.fixture
def capped(monkeypatch):
    monkeypatch.setenv("GDPT_PACKET", "1")
    monkeypatch.setenv("GDPT_MAX_TABLE_MB", "0")


def both(name):
    if name not in _CACHE:
        _CACHE[name] = (port_render(name, max_table_mb=0), reference_render(name))
    return _CACHE[name]


@pytest.mark.parametrize("name", NAMES)
def test_max_table_mb_matches_reference_super16(name, capped):
    check_route(name, *both(name))


def check_views(name):
    """The port's view holds a super16 table and nothing else to walk;
    the reference's holds one too wherever the scene is large enough."""
    from gdpt_tpu.integrators import path_soa as jpath
    from gdpt_tpu_torch.integrators import path_soa as tpath

    scene = build(name, "port")
    g = tpath.scene_soa_from_aos(scene, max_table_mb=0).geom
    assert g.sup16 is not None and g.packet is None and g.bvh_nodes48 is None
    st = scene.static
    jg = jpath.scene_soa_from_aos(build(name, "reference")).geom
    assert jg.packet is None
    assert (jg.sup16 is not None) == (st.n_tris + st.n_spheres > 128)
    if jg.sup16 is not None:
        assert (g.sup16.leaf, g.sup16.stack_n) == (jg.sup16.leaf_dummy.shape[0],
                                                   jg.sup16.depth_dummy.shape[0])


@pytest.mark.parametrize("name", NAMES)
def test_both_views_walk_super16(name, capped):
    check_views(name)
