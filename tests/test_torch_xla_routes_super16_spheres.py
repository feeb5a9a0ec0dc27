"""render.render(..., max_table_mb=0) of the material box against gdpt_tpu
under GDPT_PACKET=1 GDPT_MAX_TABLE_MB=0: the 16x16 material box with two
small icosphere balls (181 primitives) holds nine spheres, more than
SPH_BRUTE_MAX, so both super16 tables carry sphere slots and both walks
take their sphere branch (n_tris). The gates of
tests/test_torch_xla_routes_super16.py; a file of its own, as the
reference's walk with sphere slots compiles for about a minute.
"""

from test_torch_packet import one_thread  # noqa: F401 (autouse fixture)
from test_torch_xla_routes import check_route
from test_torch_xla_routes_super16 import both, capped, check_views  # noqa: F401 (fixture)


def test_max_table_mb_matches_reference_super16(capped):  # noqa: F811
    check_route("material_path", *both("material_path"))


def test_both_views_walk_super16(capped):  # noqa: F811
    check_views("material_path")
