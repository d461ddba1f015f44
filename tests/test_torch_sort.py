"""Port parity of the stable sort (K4) and of the voxelizer's
``voxel_order`` routing.

The plain twins (``mv3d_tpu_torch/ops/sort.py``: the radix twin the K4
wrapper runs on CPU tensors, and the port of the jnp bitonic network)
against the JAX Pallas kernel they replace (``bitonic_sort_pallas`` in
interpret mode), the JAX pure-jnp network, numpy's stable argsort and
``torch.sort(stable=True)``; the radix twin's pass plan on keys that need
0 to 4 digit passes; the plain twin of the long-row route (radix blocks,
then stable merges) against the same; the wrapper's choice of kernels by
row length and its launches for long rows; then the port's voxelizer at
``voxel_order="pallas-sort"``/``"bitonic"`` against JAX's eager
``lidar_to_top_batch`` at ``"pallas-sort"`` (K4, then the fused sweep, both
in interpret mode). A sort only moves values, so every comparison is
bit-exact; the density channel is held to 1 ulp as in
tests/test_torch_voxelize.py. The CUDA kernel against the plain network
is in tests/test_torch_cuda.py.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from mv3d_tpu.config import kitti_config
from mv3d_tpu.ops import sort as jsort
from mv3d_tpu.ops import voxelize as jvox
from mv3d_tpu.ops.sort_pallas import bitonic_sort_pallas
from mv3d_tpu_torch.ops import sort_bitonic
from mv3d_tpu_torch.ops import voxelize as tvox
from mv3d_tpu_torch.ops.sort import (bitonic_sort_stable, merge_runs_stable,
                                     merge_sort_stable, radix_pass_plan,
                                     radix_sort_stable)

from test_torch_config import to_port_config

torch.set_num_threads(2)

KINDS = ("ties", "equal", "negative")
SIZES = (256, 8192)

CFG = kitti_config()
SMALL = dataclasses.replace(
    CFG, top=dataclasses.replace(CFG.top, x_max=8.0, y_min=-3.0, y_max=3.0),
    pipeline=dataclasses.replace(CFG.pipeline, use_pallas_fused=True))


def sort_inputs(n, seed=0):
    """(3, n) int32 keys, one row per kind: heavy ties (values in [0, 16)),
    all equal (stability alone decides), negative keys including the int32
    extremes; and two f32 payload rows each."""
    rng = np.random.RandomState(seed)
    neg = rng.randint(-1000, 1000, n)
    neg[:4] = [-2 ** 31, 2 ** 31 - 1, -1, 0]
    keys = np.stack([rng.randint(0, 16, n), np.full(n, 7), neg]
                    ).astype(np.int32)
    return keys, rng.rand(3, n).astype(np.float32), \
        rng.rand(3, n).astype(np.float32)


@pytest.fixture(scope="module")
def sorted_rows():
    """Per size: the inputs, JAX K4 (interpret mode) and the JAX jnp
    network, each over the three rows at once."""
    out = {}
    for n in SIZES:
        keys, p1, p2 = sort_inputs(n)
        pallas = jax.vmap(lambda k, a, b: bitonic_sort_pallas(
            k, (a, b), interpret=True))(keys, p1, p2)
        jnp_net = jax.jit(jax.vmap(lambda k, a, b: jsort.bitonic_sort_stable(
            k, (a, b))))(keys, p1, p2)
        out[n] = ((keys, p1, p2), [np.asarray(x) for x in pallas],
                  [np.asarray(x) for x in jnp_net])
    return out


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", SIZES)
def test_plain_network_matches_jax_sorts(sorted_rows, n, kind):
    (keys, p1, p2), pallas, jnp_net = sorted_rows[n]
    row = KINDS.index(kind)
    got = sort_bitonic.bitonic_sort_batched(
        *(torch.from_numpy(a[row:row + 1]) for a in (keys, p1, p2)))
    order = np.argsort(keys[row], kind="stable")
    for g, pa, jn, src in zip(got, pallas, jnp_net, (keys, p1, p2)):
        g = g[0].numpy()
        np.testing.assert_array_equal(g, pa[row])
        np.testing.assert_array_equal(g, jn[row])
        np.testing.assert_array_equal(g, src[row][order])


def test_plain_network_sorts_every_row_of_a_batch():
    """Rows are sorted independently, leading dims of any rank."""
    keys, p1, _ = sort_inputs(512, seed=1)
    k, p = bitonic_sort_stable(torch.from_numpy(keys).reshape(3, 1, 512),
                               (torch.from_numpy(p1).reshape(3, 1, 512),))
    order = np.argsort(keys, axis=1, kind="stable")
    np.testing.assert_array_equal(k.reshape(3, 512).numpy(),
                                  np.take_along_axis(keys, order, 1))
    np.testing.assert_array_equal(p.reshape(3, 512).numpy(),
                                  np.take_along_axis(p1, order, 1))


def test_cpu_tensors_take_the_plain_network():
    keys, p1, p2 = (torch.from_numpy(a[:1, :256]) for a in sort_inputs(256))
    before = sort_bitonic.bitonic_sort_batched.launches
    got = sort_bitonic.bitonic_sort_batched(keys, p1, p2)
    assert sort_bitonic.bitonic_sort_batched.launches == before
    want = bitonic_sort_stable(keys, (p1, p2))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    for kernel in (sort_bitonic.bitonic_sort_kernel,
                   sort_bitonic.radix_sort_kernel,
                   sort_bitonic.merge_sort_kernel):
        with pytest.raises(ValueError, match="CUDA"):
            kernel(keys, p1, p2)
    assert sort_bitonic.merge_pass_kernel.launches == 0
    with pytest.raises(ValueError, match="power-of-two"):
        sort_bitonic.bitonic_sort_batched(keys[:, :200], p1[:, :200],
                                          p2[:, :200])


# chip_smoke.sort_cases' kinds and the digit passes each needs
PASSES = {"equal": 0, "ties": 1, "wide": 2, "voxel": 3, "negative": 4,
          "runs": 1}


@pytest.fixture(scope="module")
def radix_rows():
    """chip_smoke.sort_cases at n = 2,048 (B=2) and JAX K4 (interpret
    mode) on each kind's rows."""
    out = {}
    for kind, (keys, p1, p2) in chip_smoke.sort_cases(
            np.random.RandomState(5), 2, 2048).items():
        pallas = jax.vmap(lambda k, a, b: bitonic_sort_pallas(
            k, (a, b), interpret=True))(keys, p1, p2)
        out[kind] = ((keys, p1, p2), [np.asarray(x) for x in pallas])
    return out


@pytest.mark.parametrize("kind", list(PASSES))
def test_radix_twin_matches_jax_kernel_and_torch_sort(radix_rows, kind):
    """The radix twin (what the wrapper runs on CPU tensors) bit-equal to
    JAX's K4 in interpret mode and to torch.sort(stable=True) + gathers,
    on keys that need 0 to 4 digit passes."""
    (keys, p1, p2), pallas = radix_rows[kind]
    args = [torch.from_numpy(a) for a in (keys, p1, p2)]
    got = radix_sort_stable(args[0], args[1:])
    skey, order = torch.sort(args[0], dim=-1, stable=True)
    lib = (skey, torch.gather(args[1], -1, order),
           torch.gather(args[2], -1, order))
    for g, pa, w in zip(got, pallas, lib):
        np.testing.assert_array_equal(g.numpy(), pa)
        assert torch.equal(g, w)
    plain = sort_bitonic.bitonic_sort_batched(*args)
    assert all(torch.equal(g, p) for g, p in zip(got, plain))


@pytest.mark.parametrize("kind", list(PASSES))
def test_radix_pass_plan(kind):
    """The min/max plan sorts only the 8-bit digits at or below the
    highest bit that varies: 0 passes for equal keys, 1 inside a byte, 2
    for [0, 4096), 3 for voxel ids below 2**24, 4 across the int32 range;
    each row of a batch has its own plan."""
    keys = chip_smoke.sort_cases(np.random.RandomState(6), 3, 512)[kind][0]
    flipped = keys.astype(np.int64) + 2 ** 31
    for row in flipped:
        plan = radix_pass_plan(int(row.min()), int(row.max()))
        assert plan == [8 * p for p in range(PASSES[kind])]
    assert radix_pass_plan(0, 2 ** 32 - 1) == [0, 8, 16, 24]
    assert radix_pass_plan(256, 511) == [0]
    assert radix_pass_plan(255, 256) == [0, 8]


def test_radix_twin_sorts_rows_of_any_length_and_rank():
    """Rows are sorted independently, with leading dims of any rank and
    lengths that are not powers of two (the twin itself needs none)."""
    rng = np.random.RandomState(7)
    keys = rng.randint(-50, 50, (2, 3, 77)).astype(np.int32)
    keys[1, 2] = 9                              # one row of equal keys
    pay = rng.rand(2, 3, 77).astype(np.float32)
    k, p = radix_sort_stable(torch.from_numpy(keys), (torch.from_numpy(pay),))
    order = np.argsort(keys, axis=-1, kind="stable")
    np.testing.assert_array_equal(k.numpy(),
                                  np.take_along_axis(keys, order, -1))
    np.testing.assert_array_equal(p.numpy(),
                                  np.take_along_axis(pay, order, -1))


@pytest.mark.parametrize("n,kernel", [(256, "radix"), (65536, "radix"),
                                      (131072, "merge"), (262144, "merge")])
def test_sort_kernel_is_chosen_by_row_length(monkeypatch, n, kernel):
    """Rows of at most RADIX_CAPACITY (65,536) go to the cluster radix
    kernel, longer ones to radix blocks plus merge passes: a rule on the
    shape."""
    calls = []
    for name in ("radix", "merge"):
        monkeypatch.setattr(sort_bitonic, f"{name}_sort_kernel",
                            lambda *a, name=name: calls.append(name))
    key = torch.zeros(1, n, dtype=torch.int32)
    sort_bitonic.bitonic_sort_kernel(key, key.float(), key.float())
    assert calls == [kernel]
    assert sort_bitonic.RADIX_CAPACITY == 65536


@pytest.mark.parametrize("n,passes", [(131072, 1), (262144, 2),
                                      (1048576, 4)])
def test_long_rows_take_radix_blocks_then_merge_passes(monkeypatch, n,
                                                       passes):
    """A row of 65,536 * 2**k is sorted as 2**k radix rows in one launch,
    then k merge passes of doubling run length, ping-ponging so that the
    last pass writes the output buffer and not the scratch."""
    launches = []

    def radix(src, rows, length, dst, device):
        launches.append(("radix", (rows, length), dst[0]))

    def merge(src, bsz, length, run, dst, device):
        assert (bsz, length) == (2, n)
        launches.append(("merge", run, dst[0]))

    monkeypatch.setattr(sort_bitonic, "_cuda_inputs",
                        lambda *a: tuple(t.contiguous() for t in a))
    monkeypatch.setattr(sort_bitonic, "_radix_launch", radix)
    monkeypatch.setattr(sort_bitonic, "merge_pass_kernel", merge)
    key = torch.zeros(2, n, dtype=torch.int32)
    out = sort_bitonic.merge_sort_kernel(key, key.float(), key.float())
    blocks = 2 * n // 65536
    assert [x[:2] for x in launches] == [("radix", (blocks, 65536))] + [
        ("merge", 65536 * 2 ** p) for p in range(passes)]
    assert launches[-1][2] == out[0].data_ptr()
    writes = [x[2] for x in launches]
    assert all(a != b for a, b in zip(writes, writes[1:]))


@pytest.fixture(scope="module")
def merge_rows():
    """chip_smoke.sort_cases at n = 1,024 and 2,048 (B=2) and JAX K4
    (interpret mode) on each kind's rows."""
    out = {}
    for n in (1024, 2048):
        for kind, (keys, p1, p2) in chip_smoke.sort_cases(
                np.random.RandomState(n), 2, n).items():
            pallas = jax.vmap(lambda k, a, b: bitonic_sort_pallas(
                k, (a, b), interpret=True))(keys, p1, p2)
            out[n, kind] = ((keys, p1, p2), [np.asarray(x) for x in pallas])
    return out


@pytest.mark.parametrize("kind", list(PASSES))
@pytest.mark.parametrize("n,block", [(1024, 256), (2048, 512)])
def test_merge_twin_matches_radix_twin_jax_kernel_and_torch_sort(
        merge_rows, n, block, kind):
    """The plain twin of the long-row route (radix blocks of ``block``
    elements, then two stable merge passes)
    bit-equal to the radix twin of the whole row, to
    torch.sort(stable=True) + gathers and to JAX's K4 in interpret mode,
    on keys that need 0 to 4 digit passes and on ties across runs."""
    (keys, p1, p2), pallas = merge_rows[n, kind]
    args = [torch.from_numpy(a) for a in (keys, p1, p2)]
    got = merge_sort_stable(args[0], args[1:], block)
    whole = radix_sort_stable(args[0], args[1:])
    skey, order = torch.sort(args[0], dim=-1, stable=True)
    lib = (skey, torch.gather(args[1], -1, order),
           torch.gather(args[2], -1, order))
    for g, w, l, pa in zip(got, whole, lib, pallas):
        assert torch.equal(g, w) and torch.equal(g, l)
        np.testing.assert_array_equal(g.numpy(), pa)


def test_merge_pass_takes_the_left_run_first_on_ties():
    """One merge pass of two sorted runs: equal keys keep the left run's
    elements (lower original indices) ahead of the right run's, and the
    payloads follow their keys."""
    key = torch.tensor([[1, 3, 3, 5, 1, 3, 4, 5]], dtype=torch.int32)
    pos = torch.arange(8, dtype=torch.float32)[None]
    k, p = merge_runs_stable([key, pos], 4)
    assert k.tolist() == [[1, 1, 3, 3, 3, 4, 5, 5]]
    assert p.tolist() == [[0, 4, 1, 2, 5, 6, 3, 7]]
    with pytest.raises(ValueError, match="pairs"):
        merge_runs_stable([key[:, :6]], 4)


def _with(cfg, **pipeline):
    return dataclasses.replace(cfg, pipeline=dataclasses.replace(
        cfg.pipeline, **pipeline))


@pytest.fixture(scope="module")
def tricky_batch():
    """Two tricky clouds of 8,192 points (boundary z values, duplicated
    positions with other reflectance, points around the crop box), the
    second one padded after 6,000 points."""
    pts = chip_smoke.make_cloud(np.random.RandomState(11), 2, 8192, SMALL,
                                tricky=True)
    pts[1, 6000:] = -1e9
    return pts, np.array([8192, 6000], np.int32)


@pytest.mark.parametrize("layout", ["hwc", "s2d2"])
def test_voxelizer_pallas_sort_matches_jax(tricky_batch, layout):
    """The port at "pallas-sort" and "bitonic" against JAX's eager view at
    "pallas-sort" (K4 + the sorted sweep, interpret mode) and the port at
    "sort": views and occupancies bit-equal (density within 1 ulp of
    JAX's); the port's own views bit-equal outright."""
    pts, num = tricky_batch
    jcfg = _with(SMALL, view_layout=layout, voxel_order="pallas-sort")
    jtop, jocc = (np.asarray(x) for x in jvox.lidar_to_top_batch(
        pts, jcfg, num, return_occ=True))
    p, n = torch.from_numpy(pts), torch.from_numpy(num)
    views = {order: tvox.lidar_to_top_batch(
        p, to_port_config(_with(jcfg, voxel_order=order)), n,
        return_occ=True) for order in ("pallas-sort", "bitonic", "sort")}
    dens = (np.s_[..., SMALL.top.zn + 1] if layout == "hwc"
            else np.s_[..., -4:])
    rest = (np.s_[..., :SMALL.top.zn + 1] if layout == "hwc"
            else np.s_[..., :-4])
    for top, occ in views.values():
        np.testing.assert_array_equal(top.numpy()[rest], jtop[rest])
        np.testing.assert_array_max_ulp(top.numpy()[dens], jtop[dens],
                                        maxulp=1)
        np.testing.assert_array_equal(occ.numpy(), jocc)
        assert torch.equal(top, views["sort"][0])
        assert torch.equal(occ, views["sort"][1])
    assert (jocc > 0).sum() > 100


def test_voxel_order_routes_the_sort(tricky_batch, monkeypatch):
    """Which orders and sizes sort: "pallas-sort"/"bitonic" at a
    power-of-two N, once per batch; nothing at other N (where JAX takes
    lax.sort), for "sort"/"bin", on the s2d2p branch, without
    use_pallas_fused (where JAX scatters with XLA) or with a host aux
    plane; "pallas-sort" below 256 points raises, "bitonic" sorts."""
    calls = []

    def spy(*args):
        calls.append(args[0].shape)
        return sort_bitonic.bitonic_sort_plain(*args)

    monkeypatch.setattr(tvox, "bitonic_sort_batched", spy)
    pts, num = tricky_batch
    p = torch.from_numpy(pts)

    def run(n_pts, **kw):
        calls.clear()
        tvox.lidar_to_top_batch(p[:, :n_pts], to_port_config(
            _with(SMALL, **kw)))
        return list(calls)

    assert run(8192, voxel_order="pallas-sort") == [(2, 8192)]
    assert run(8192, voxel_order="bitonic", view_layout="s2d2") == [(2, 8192)]
    assert run(128, voxel_order="bitonic") == [(2, 128)]
    assert run(6000, voxel_order="pallas-sort") == []
    assert run(8192, voxel_order="sort") == []
    assert run(8192, voxel_order="bin") == []
    assert run(8192, voxel_order="pallas-sort", view_layout="s2d2p") == []
    assert run(8192, voxel_order="pallas-sort", use_pallas_fused=False) == []
    calls.clear()
    t = SMALL.top
    tvox.lidar_to_top_batch(p, to_port_config(_with(
        SMALL, voxel_order="pallas-sort")),
        aux=torch.zeros(2, t.xn, t.yn, 2))
    assert calls == []
    with pytest.raises(ValueError, match="256"):
        run(128, voxel_order="pallas-sort")
    with pytest.raises(ValueError, match="voxel_order"):
        run(8192, voxel_order="radix")
