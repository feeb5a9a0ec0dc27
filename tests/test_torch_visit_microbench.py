"""The port's visit microbenchmark (K5) against tools/visit_microbench.py.

On the CPU `visit_microbench` runs K5's plain version. Leaf modes are held
against the reference's Pallas kernel, run in interpret mode
(`tools/visit_microbench.build` has no interpret argument, so the test
wraps `pallas_call` for the call; nothing in tools/ changes), on one
1024-ray packet over a small table with n_visits = 64. The rows are
pseudo-random over the whole table, so supernode rows are read as leaves:
garbage geometry on which an ulp between XLA's CPU code and torch can
flip a hit, and the pair mode folds its two rows in another order than
the reference (ties only). Gate: prim equal on at least 99% of lanes, t
within rtol 1e-5 where prim agrees. Found on this table: 100% of lanes
equal in every leaf mode. Super modes are held against a numpy
evaluation of the slab test (the reference keeps only the packet-wide OR,
which is compared too), and the row sequence against numpy int32
arithmetic.

The gpu-marked test holds the CUDA kernel against its plain version, bit
for bit, in every mode:
    python -m pytest --noconftest -m gpu tests/test_torch_visit_microbench.py
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from gdpt_tpu_torch.accel import packet_trace as tpt
from gdpt_tpu_torch.tools import visit_microbench as vm

from test_torch_packet import (_carry, _reference_table, _table_case,
                               one_thread)  # noqa: F401 (autouse fixture)

N_VISITS = 64
_CACHE = {}


def _tables():
    if "tab" not in _CACHE:
        args, kw = _table_case("triangles", 16)
        ref = _reference_table(args, **kw)
        _CACHE["tab"] = (ref, _carry(ref))
    return _CACHE["tab"]


def _rays(tab, n=1024):
    return vm.random_rays(tab, n, seed=0)


def _reference_run(mode, monkeypatch):
    """(t, prim) of the reference's kernel in interpret mode."""
    import jax.experimental.pallas as pl
    import jax.numpy as jnp

    spec = importlib.util.spec_from_file_location(
        "reference_visit_microbench",
        Path(__file__).resolve().parents[1] / "tools" / "visit_microbench.py")
    ref_vm = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref_vm)
    real = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call", lambda *a, **k: real(*a, **{**k, "interpret": True}))
    jtab, tab = _tables()
    f = ref_vm.build(jtab, N_VISITS, mode)
    import jax

    tabf = jax.lax.bitcast_convert_type(jtab.table, jnp.float32)
    args = [jnp.asarray(r.numpy().reshape(-1, 128)) for r in _rays(tab)]
    t, prim = f(jtab.table, tabf, *args)
    return np.asarray(t).reshape(-1), np.asarray(prim).reshape(-1)


@pytest.mark.parametrize("mode", ["leaf", "leaf2", "leaf24", "super_leaf"])
def test_leaf_modes_match_the_reference_kernel(mode, monkeypatch):
    _, tab = _tables()
    t, prim, word = vm.visit_microbench(tab, *_rays(tab), N_VISITS, mode)
    jt, jp = _reference_run(mode, monkeypatch)
    same = prim.numpy() == jp
    assert same.mean() >= 0.99, same.mean()
    assert (jp >= 0).mean() > 0.2  # the visits do find hits
    np.testing.assert_allclose(t.numpy()[same], jt[same], rtol=1e-5)
    assert (word != 0).any() == (mode == "super_leaf")


def _numpy_super_words(tab, rays, n_visits, mode):
    """Per-ray OR of the child masks in numpy f32, in the walk's order."""
    table = tab.table.numpy()
    tf = table.view(np.float32)
    ox, oy, oz, dx, dy, dz, tn, best = (r.numpy() for r in rays)
    with np.errstate(all="ignore"):
        inv = [np.float32(1) / np.where(np.abs(c) < 1e-18, np.where(c < 0, -1e-20, 1e-20), c)
               .astype(np.float32) for c in (dx, dy, dz)]
        oinv = [o * i for o, i in zip((ox, oy, oz), inv)]
        word = np.zeros(ox.shape[0], np.int64)
        n_iters = vm.n_iterations(n_visits, mode)
        for row, row2 in zip(*vm.row_sequence(n_iters, table.shape[0])):
            if mode == "empty":
                word |= int(np.uint32(table[row, 120]))
                continue
            visits = {"super2": [[row], [row2]], "super32": [[row, row2]]}.get(mode, [[row]])
            for rows in visits:
                mask = np.zeros_like(word)
                for k in range(16 * len(rows)):
                    b = tf[rows[k >> 4], (k & 15) * 6:(k & 15) * 6 + 6]
                    t0 = [b[a] * inv[a] - oinv[a] for a in range(3)]
                    t1 = [b[a + 3] * inv[a] - oinv[a] for a in range(3)]
                    lo = [np.minimum(p, q) for p, q in zip(t0, t1)]
                    hi = [np.maximum(p, q) for p, q in zip(t0, t1)]
                    t_in = np.maximum(np.maximum(lo[0], lo[1]), np.maximum(lo[2], tn))
                    t_out = np.minimum(np.minimum(hi[0], hi[1]), np.minimum(hi[2], best))
                    mask |= (t_in <= t_out).astype(np.int64) << k
                word |= mask & int(np.uint32(table[rows[0], 120]))
    return word


@pytest.mark.parametrize("mode", ["empty", "super", "super_sld", "super2", "super32"])
def test_super_modes_match_numpy_slab_tests(mode):
    _, tab = _tables()
    rays = _rays(tab, 512)
    t, prim, word = vm.visit_microbench(tab, *rays, N_VISITS, mode)
    assert torch.equal(t, rays[7]) and (prim == -1).all()  # no leaf visit, no hit
    expect = _numpy_super_words(tab, rays, N_VISITS, mode)
    got = word.numpy().astype(np.int64) & 0xFFFFFFFF
    np.testing.assert_array_equal(got, expect)
    assert got.any() and len(np.unique(got)) > (1 if mode != "empty" else 0)


@pytest.mark.parametrize("a,b", [("leaf", "leaf_sld"), ("super", "super_sld")])
def test_scalar_load_modes_equal_their_vector_load_modes(a, b):
    _, tab = _tables()
    rays = _rays(tab, 256)
    for x, y in zip(vm.visit_microbench(tab, *rays, N_VISITS, a),
                    vm.visit_microbench(tab, *rays, N_VISITS, b)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("n_rows", [1, 7, 47_694, 2 ** 22 - 1])
def test_row_sequence_is_the_reference_int32_arithmetic(n_rows):
    row, row2 = vm.row_sequence(10_000, n_rows)
    with np.errstate(over="ignore"):
        it = np.arange(10_000, dtype=np.int32)
        ref = ((it * np.int32(747796405)) & np.int32(0x7FFFFFFF)) % np.int32(n_rows)
        ref2 = ((it * np.int32(1103515245)) & np.int32(0x7FFFFFFF)) % np.int32(n_rows)
    np.testing.assert_array_equal(row, ref)
    np.testing.assert_array_equal(row2, ref2)
    assert row.min() >= 0 and row.max() < n_rows


def test_pair_modes_run_half_the_iterations_and_work_is_counted():
    _, tab = _tables()
    assert [vm.n_iterations(64, m) for m in ("super2", "leaf2", "super_leaf", "leaf24",
                                             "super32", "leaf")] == [32, 32, 32, 64, 64, 64]
    ops, rows = vm.visit_work(tab, 64, "super")
    assert ops == 64 * 16 * 25 and 1 <= rows <= 64
    ops_leaf, _ = vm.visit_work(tab, 64, "leaf")
    seq, _ = vm.row_sequence(64, tab.table.shape[0])
    ids = (tab.table[:, 108:120] >= 0).sum(dim=1).numpy()
    assert ops_leaf == int(ids[seq].sum()) * 52
    assert vm.visit_work(tab, 64, "super_leaf")[0] > 32 * 16 * 25
    assert vm.visit_work(tab, 64, "empty")[0] == 0


@pytest.mark.parametrize("bad", ["mode", "n_visits", "device", "dtype"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    _, tab = _tables()
    rays = list(_rays(tab, 128))
    mode, n_visits = "leaf", 8
    if bad == "mode":
        mode = "leaf3"
    elif bad == "n_visits":
        n_visits = -1
    elif bad == "device":
        rays = [r.to("meta") for r in rays]
        tab = tab._replace(table=tab.table.to("meta"))
    else:
        rays[2] = rays[2].double()
    before = dict(vm.LAUNCHES)
    with pytest.raises(ValueError):
        vm.visit_microbench(tab, *rays, n_visits, mode)
    assert vm.LAUNCHES == before


def test_timed_run_needs_a_card():
    _, tab = _tables()
    with pytest.raises(ValueError, match="CUDA"):
        vm.run(tab, 128, 8)


def _cuda_cases():
    """(table, n_rays, n_visits) on the card: both widths with a ray count
    that is no multiple of a block's rays and more iterations than the
    ring has stages; ray counts around one and four rays a thread and a
    block's 512; tables of one and two rows, where the ring stages the
    same row again and again; zero, one and three visits (odd for the
    pair modes)."""
    tabs = {}
    for wide in (16, 32):
        args, kw = _table_case("triangles", wide)
        tabs[wide] = tpt.packet_table_to(tpt.build_packet_table(*args, **kw), "cuda")
    cut = lambda wide, rows: tabs[wide]._replace(  # noqa: E731
        table=tabs[wide].table[:rows].contiguous())
    return ([(tabs[w], 65_536 + 77, 128) for w in (16, 32)]
            + [(tabs[16], n, 37) for n in (0, 1, 3, 5, 511, 513)]
            + [(cut(w, r), 1000, 40) for w, r in ((16, 1), (16, 2), (32, 2))]
            + [(tabs[32], 700, v) for v in (0, 1, 3)])


@pytest.mark.gpu
@pytest.mark.parametrize("mode", vm.MODES)
def test_cuda_kernel_matches_plain(mode):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for tab, n, n_visits in _cuda_cases():
        rays = vm.random_rays(tab, n, seed=3)
        before = vm.LAUNCHES[mode]
        got = vm.visit_microbench(tab, *rays, n_visits, mode)
        assert vm.LAUNCHES[mode] == before + (n > 0)
        ref = vm.visit_microbench_plain(tab, *rays, n_visits, mode)
        torch.cuda.synchronize()
        for a, b in zip(got, ref):  # t, prim and the mask word, bit for bit
            assert torch.equal(a.view(torch.int32), b.view(torch.int32)), (
                tab.table.shape[0], n, n_visits)
