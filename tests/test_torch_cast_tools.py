"""The port's cast A/B tools (gdpt_tpu_torch/tools/trace_decompose.py,
ab_dual_kernel.py, ab_wide_kernel.py, chain_sweep.py, occl_ab.py) against
the reference's, on the CPU.

trace_decompose, ab_dual_kernel, ab_wide_kernel and chain_sweep launch the
Pallas walk outside interpret mode in the reference, so their tools cannot
run here. Instead, on the captured pool rays of a level-2 icosphere box
(16x16, a pool of 1,024 lanes, one warm chunk), the port's sort
(ab_dual_kernel._sorted_packets) is held to the reference's
tools/ab_dual_kernel._sorted_packets on the same numpy rays: equal sorted
keys, and equal rays wherever the key is unique (the reference's argsort
need not keep the order of equal keys); and the port's walk on them (K3's
plain version on the CPU) to the reference's
packet_trace._trace_packets(..., interpret=True): equal prims, t within
rtol 1e-6 (the plain walks match the Pallas kernels to an ulp). The tools'
own checks must fire: _check_equal on a table with one triangle moved,
K4 against K3 on differing hits, trace_decompose on a walk that answers
differently from one call to the next, occl_ab on a compacted cast that
differs. occl_ab runs the reference's main() on a 16x16 cbox file (K2's
plain version in the port): on the reference's own captured pool rays the
port gives the same pool, live shadow rays and compacted width, exactly.
On the port's capture, which agrees with the reference's to 1e-2 in
origins, the live count moves by a few percent: both tools cast the pool
rays from tnear 0, as the reference's occl_ab does, so a bounce ray's hit
of its own surface turns on the last ulps of its origin, and NEE at such a
hit needs no shadow ray (a zero BSDF): 23 of 1,024 lanes here. That
count is held to within 5% of the pool. Each tool's main() without a card and without --device
cpu prints one error line and returns 2.
"""

import os

import numpy as np
import pytest
import torch

from gdpt_tpu_torch.accel import packet_kernels as pk
from gdpt_tpu_torch.accel import packet_trace as pt
from gdpt_tpu_torch.integrators import path_soa as tps
from gdpt_tpu_torch.scene import presets, xml_writer
from gdpt_tpu_torch.scene.build import scene_to
from gdpt_tpu_torch.tools import (ab_dual_kernel, ab_wide_kernel, chain_sweep, occl_ab,
                                  stand_ins, trace_decompose)
from gdpt_tpu_torch.tools import wavefront_visits as twv

from test_torch_bench import reference_script
from test_torch_packet import one_thread  # noqa: F401 (autouse fixture)
from test_torch_profile_tools import run_reference

TOOLS = [trace_decompose, ab_dual_kernel, ab_wide_kernel, chain_sweep, occl_ab]
POOL = 1024
_CACHE = {}


def _box():
    """(reference box, port box on the CPU, captured pool rays)."""
    if "box" not in _CACHE:
        from test_torch_bvh import port_box, reference_box

        ts = scene_to(port_box(16, 16, 1, level=2), "cpu")
        rays = twv.capture_pool_rays(ts, warm_chunks=1, pool=POOL)
        _CACHE["box"] = (reference_box(16, 16, 1, level=2), ts, rays)
    return _CACHE["box"]


def _reference_table(js):
    """The reference's packet table of a scene: on the CPU its casts take
    the XLA walk unless GDPT_PACKET=1, which is set only for this call."""
    from gdpt_tpu.accel import traverse_soa as jts

    before = os.environ.get("GDPT_PACKET")
    os.environ["GDPT_PACKET"] = "1"
    try:
        return jts.geom_soa_from_aos(js.device.geom).packet
    finally:
        if before is None:
            del os.environ["GDPT_PACKET"]
        else:
            os.environ["GDPT_PACKET"] = before


def _v3(rays, keys, lib):
    return tuple(lib(np.ascontiguousarray(rays[k])) for k in keys)


def _sorted():
    """(reference packed rays, reference table, port sorted rays, port
    table, n, the port's unsorted (org, d))."""
    if "sorted" not in _CACHE:
        import jax.numpy as jnp
        from gdpt_tpu.core.soa import V3 as JV3

        js, ts, rays = _box()
        eps = float(ts.static.intersection_epsilon)
        jtab = _reference_table(js)
        ref_tool = reference_script("tools/ab_dual_kernel.py")
        jpacked, _ = ref_tool._sorted_packets(
            jtab, JV3(*_v3(rays, ("ox", "oy", "oz"), jnp.asarray)),
            JV3(*_v3(rays, ("dx", "dy", "dz"), jnp.asarray)), eps)
        tab = tps.scene_soa_from_aos(ts).geom.packet
        org = pt.V3(*_v3(rays, ("ox", "oy", "oz"), torch.from_numpy))
        d = pt.V3(*_v3(rays, ("dx", "dy", "dz"), torch.from_numpy))
        packed, n = ab_dual_kernel._sorted_packets(tab, org, d, eps)
        _CACHE["sorted"] = (jpacked, jtab, packed, tab, n, (org, d))
    return _CACHE["sorted"]


def test_sorted_rays_match_reference():
    jpacked, _, packed, tab, n, (org, d) = _sorted()
    assert n == POOL and len(packed) == len(jpacked) == 8
    keys = pt._morton_keys(tab, org, d)
    sk = torch.sort(keys).values.numpy()
    unique = np.ones(n, bool)
    unique[1:] &= sk[1:] != sk[:-1]
    unique[:-1] &= sk[:-1] != sk[1:]
    assert unique.mean() > 0.5
    for got, ref in zip(packed[:7], jpacked[:7]):
        ref = np.asarray(ref).reshape(-1)[:n]
        np.testing.assert_array_equal(got.numpy()[unique], ref[unique])
    port_keys = pt._morton_keys(tab, pt.V3(*packed[:3]), pt.V3(*packed[3:6])).numpy()
    np.testing.assert_array_equal(port_keys, sk)
    assert bool((packed[7] == 3e37).all())


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any_hit"])
def test_plain_hits_match_reference_kernel(any_hit):
    from gdpt_tpu.accel import packet_trace as jpt

    jpacked, jtab, _, tab, n, _ = _sorted()
    rays = [torch.from_numpy(np.array(a).reshape(-1)) for a in jpacked]
    t, prim = pk.trace_packets(tab, *rays, any_hit=any_hit)
    jt, jp = (np.asarray(a).reshape(-1) for a in jpt._trace_packets(
        jtab, *jpacked, any_hit=any_hit, interpret=True))
    if any_hit:
        np.testing.assert_array_equal(prim.numpy() >= 0, jp >= 0)
    else:
        np.testing.assert_array_equal(prim.numpy(), jp)
        np.testing.assert_allclose(t.numpy(), jt, rtol=1e-6)
    assert 0.3 < float((prim >= 0).double().mean()) < 1.0


def _moved_triangle(tab, prim):
    """tab with the leaf slot of `prim` moved 1e4 units away: one row
    changed."""
    table = tab.table.clone()
    f = table.view(torch.float32)
    rows, slots = torch.nonzero(table[:, 108:120] == prim, as_tuple=True)
    for r, s in zip(rows.tolist(), slots.tolist()):
        if torch.equal(f[r, 9 * s:9 * s + 9], tab.geo9[prim]):
            f[r, 9 * s:9 * s + 3] += 1e4
            return tab._replace(table=table)
    raise AssertionError(f"prim {prim} not found in a leaf row")


def test_check_equal_passes_on_both_widths_and_fires_on_a_changed_row():
    _, _, packed, tab32, n, _ = _sorted()
    _, ts, _ = _box()
    tab16 = tps.scene_soa_from_aos(ts, wide=16).geom.packet
    for any_hit in (False, True):
        ab_wide_kernel._check_equal(tab16, tab32, packed, n, any_hit=any_hit)
    prim = pk.trace_packets(tab16, *packed)[1]
    busiest = int(torch.bincount(prim[prim >= 0]).argmax())
    broken = _moved_triangle(tab32, busiest)
    with pytest.raises(AssertionError):
        ab_wide_kernel._check_equal(tab16, broken, packed, n)


def test_dual_check_fires_on_differing_hits():
    t = torch.arange(4.0)
    p = torch.arange(4, dtype=torch.int32)
    ab_dual_kernel._check_same((t, p), (t.clone(), p.clone()), "pool")
    with pytest.raises(AssertionError, match="1 pool rays"):
        ab_dual_kernel._check_same((t, p), (t, torch.tensor([0, 1, 2, 5], dtype=torch.int32)),
                                   "pool")


def test_ab_tools_run_on_the_cpu():
    _, ts, _ = _box()
    rows = ab_dual_kernel.ab(ts, pool=POOL, harvest=2048, k=2)
    labels = [r["label"] for r in rows]
    assert labels == ["table", "pool_solo", "pool_dual", "bounce_solo", "bounce_dual",
                      "shadow_solo", "shadow_dual"]
    assert rows[1]["rays"] == POOL and rows[1]["hit_frac"] == rows[2]["hit_frac"] > 0
    assert all(r["launches"] is None and r["device_ops"] is None and r["mrays"] > 0
               for r in rows[1:])
    summary = ab_dual_kernel.summary("box", rows)
    assert summary["unit"] == "Mrays/s" and summary["rows16"] == rows[0]["rows16"]
    rows = ab_wide_kernel.ab(ts, pool=POOL, harvest=2048, k=2)
    assert [r["label"] for r in rows] == ["table", "pool_16", "pool_32", "bounce_16",
                                          "bounce_32", "shadow_16", "shadow_32"]
    assert rows[0]["rows32"] < rows[0]["rows16"]


def test_trace_decompose_check_and_its_failure(monkeypatch):
    _, ts, rays = _box()
    rows = trace_decompose.decompose(ts, rays=rays, reps=1)
    by = {r["stage"]: r for r in rows}
    assert by["rays"]["rays"] == POOL and by["check"]["rays_differing"] == 0
    assert list(by) == ["rays", "sort", "trace_sorted", "trace_presorted", "kernel",
                        "kernel_any_hit", "unsort", "hit_attribs", "check"]
    calls = [0]
    walk = pk.trace_packets

    def drifting(*a, **kw):
        t, prim = walk(*a, **kw)
        calls[0] += 1
        return t + 1e-3 * calls[0], prim

    monkeypatch.setattr(pk, "trace_packets", drifting)
    with pytest.raises(AssertionError, match="pre-sorted cast"):
        trace_decompose.decompose(ts, rays=rays, reps=1)


def test_trace_decompose_main_reads_an_npz(tmp_path, capsys):
    _, ts, rays = _box()
    path = tmp_path / "rays.npz"
    np.savez(path, **rays)
    scene = xml_writer.write_scene(str(tmp_path), **presets.icosphere_box_parts(
        16, 16, 1, balls=[(2, (368.0, 100.0, 351.0), 100.0)]))
    assert trace_decompose.main([scene, str(path), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert f"{POOL} rays" in out and "0 rays differ" in out


def test_chain_sweep_and_its_fit():
    c, cast = chain_sweep.fit([1, 2, 4, 8], [1.5 + 0.25 * k for k in (1, 2, 4, 8)])
    assert c == pytest.approx(1.5) and cast == pytest.approx(0.25)
    _, ts, _ = _box()
    rows = chain_sweep.sweep(ts, pool=POOL, ks=(1, 2), reps=1)
    tab = tps.scene_soa_from_aos(ts).geom.packet
    packed, _ = ab_dual_kernel._sorted_packets(tab, *ab_dual_kernel.pool_rays(ts, POOL),
                                               float(ts.static.intersection_epsilon))
    hits = float((pk.trace_packets(tab, *packed)[1] >= 0).double().mean())
    assert rows[0] == {"hit_frac": hits, "rays": POOL, "dual": False}
    assert [r["K"] for r in rows[1:3]] == [1, 2] and rows[1]["graph_ms"] is None
    assert rows[3]["fit"] == "eager" and len(rows) == 4


@pytest.fixture(scope="module")
def cbox_file(tmp_path_factory):
    return xml_writer.write_scene(str(tmp_path_factory.mktemp("cbox")),
                                  **presets.cornell_box_parts(16, 16, 1, max_depth=6))


def test_occl_ab_matches_reference(cbox_file):
    import re

    out = run_reference("occl_ab", [cbox_file, "--pool", str(POOL), "--chain", "2"])
    pool, live = map(int, re.search(r"pool=(\d+) live_shadow=(\d+)", out).groups())
    width = int(re.search(r"\(b\) compacted (\d+):", out).group(1))
    from gdpt_tpu.scene import parser as jparser

    jwv = reference_script("tools/wavefront_visits.py")
    ref_rays = {k: np.array(v) for k, v in jwv.capture_pool_rays(
        jparser.parse_scene(cbox_file)[0], warm_chunks=3, pool=POOL).items()}
    scene = stand_ins.load(cbox_file, device="cpu")[0]
    rows = occl_ab.ab(scene, pool=POOL, chain=2, reps=1, rays=ref_rays)
    sh = rows[0]
    assert sh["pool"] == pool == POOL and sh["live_shadow"] == live and sh["width"] == width
    own = occl_ab.ab(scene, pool=POOL, chain=2, reps=1)[0]
    assert own["pool"] == POOL and abs(own["live_shadow"] - live) <= 0.05 * POOL
    assert [r["label"] for r in rows[1:]] == ["a_full", "b_compacted", "c_chained_full",
                                              "d_chained_compacted"]
    assert [r["lanes"] for r in rows[1:]] == [POOL, width, POOL, width]


def test_occl_ab_compaction_check_fires(monkeypatch):
    _, ts, rays = _box()
    real = occl_ab.compact

    def shuffled(pos, dl, tfar, live):
        p, d, tf, sel = real(pos, dl, tfar, live)
        return p, pt.V3(*(-c for c in d)), tf, sel     # the compacted rays turned around

    monkeypatch.setattr(occl_ab, "compact", shuffled)
    with pytest.raises(AssertionError, match="compacted shadow cast differs"):
        occl_ab.ab(ts, pool=POOL, chain=2, reps=1, rays=rays)


@pytest.mark.parametrize("tool", TOOLS, ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_main_refuses_without_a_card(tool, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tool.main(["icosphere_box"]) == 2
    out, err = capsys.readouterr()
    assert out == "" and len(err.strip().splitlines()) == 1 and "--device cpu" in err
