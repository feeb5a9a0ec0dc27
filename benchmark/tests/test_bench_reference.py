"""The comparison that decides `correct`: the program agrees with the
plain reference on tiny frames of each config; the control (the
reference in bfloat16 in the program's place) and each fault the cells
can have come out not correct."""

import numpy as np
import pytest

from benchmark.harness import controls
from benchmark.tests.conftest import CELLS, cpu_run, load_cell


@pytest.mark.parametrize("name", CELLS)
def test_program_agrees_with_the_reference(name):
    res, _, _ = cpu_run(load_cell(name), seconds=0.5)
    assert res["correct"], res["compared"]
    assert res["compared"]["off_share"]["value"] == 0.0


@pytest.mark.parametrize("name", CELLS)
def test_lower_precision_fails(name):
    res, _, _ = cpu_run(load_cell(name), frame_fn=controls.control)
    assert not res["correct"], res["compared"]


@pytest.mark.parametrize("fault", sorted(controls.FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_faults_fail(name, fault):
    res, _, _ = cpu_run(load_cell(name), frame_fn=controls.FAULTS[fault])
    assert not res["correct"], (fault, res["compared"])


def test_a_band_fault_is_caught_by_the_share():
    """One row altered by 1 %: the frame's mean barely moves, so only the
    share of values off the reference can catch it."""
    res, _, _ = cpu_run(load_cell(CELLS[0]), frame_fn=controls.band)
    c = res["compared"]
    assert c["off_share"]["value"] > c["off_share"]["limit"], c
    assert c["mean_gap"]["value"] <= c["mean_gap"]["limit"], c


def test_reference_casts():
    """A triangle in the plane z = 2: hit at t = 2 from the origin along
    +z (its normal by its winding), missed beside it and beyond tfar."""
    import torch

    from benchmark.reference import geometry

    tri = np.array([[[-1.0, -1.0, 2.0], [1.0, -1.0, 2.0], [0.0, 1.0, 2.0]]])
    g = geometry.Geometry.build(tri, "cpu", torch.float32)
    o = (torch.tensor([0.0, 5.0, 0.0]), torch.zeros(3), torch.zeros(3))
    d = (torch.zeros(3), torch.zeros(3), torch.ones(3))
    tfar = torch.tensor([10.0, 10.0, 1.5])
    t, prim, n = geometry.closest(g, o, d, 0.0, tfar)
    assert prim.tolist() == [0, -1, -1] and t.tolist() == [2.0, 10.0, 1.5]
    assert [c[0].item() for c in n] == [0.0, 0.0, 4.0]
    assert geometry.occluded(g, o, d, 0.0, tfar).tolist() == [True, False, False]


@pytest.mark.parametrize("entry", ("sphere", "disneymetal", "roughdielectric"))
def test_reference_refuses_what_it_cannot_draw(entry):
    """A sphere or a material given as a dict (the scene writer's other
    forms) makes reference/scene.build raise, naming the entry, rather
    than draw another scene than the program's."""
    from benchmark.harness import session
    from benchmark.reference import scene

    desc = session.describe(dict(load_cell(CELLS[0]).config, width=4, height=4))
    scene.build(desc)
    if entry == "sphere":
        sphere = {"center": (278.0, 100.0, 280.0), "radius": 60.0, "material": 0,
                  "emitter": None}
        bad, match = dict(desc, shapes=[*desc["shapes"], sphere]), "shape 8 "
    else:
        forms = {"disneymetal": {"type": "disneymetal", "base_color": (0.9, 0.9, 0.9),
                                 "roughness": 0.02},
                 "roughdielectric": {"type": "roughdielectric", "roughness": 0.02,
                                     "int_ior": 1.5, "ext_ior": 1.0}}
        bad, match = dict(desc, materials=[*desc["materials"], forms[entry]]), "material 4 "
    with pytest.raises(ValueError, match=match):
        scene.build(bad)
