"""The port's kernel modules (spark_rapids_tpu_torch/ops) against the JAX
package on the CPU. Here the kernel wrappers take their plain twins, since
the tensors lie on the CPU; the CUDA kernels themselves are held against
the same twins on the card by chip_smoke.py.

Tolerances: the murmur3 hash and the candidate counts are integer results
and must be equal bit for bit. The f64 segmented sum is held to the JAX
kernel's own contract (tests/test_pallas.py): |error| <= 1e-6 x the
group's L1 mass (+1), against numpy and against the JAX kernel."""

import numpy as np
import pyarrow as pa
import pytest
import torch

import jax.numpy as jnp

from spark_rapids_tpu.columnar import batch_from_arrow as jax_batch_from_arrow
from spark_rapids_tpu.exec.base import batch_vecs as jax_batch_vecs
from spark_rapids_tpu.exec.joins import _probe_counts as jax_probe_counts
from spark_rapids_tpu.expr.hashing import hash_vecs as jax_hash_vecs
from spark_rapids_tpu.ops import pallas_probe as jax_pallas_probe
from spark_rapids_tpu.ops.pallas_segsum import \
    segment_sum_f64 as jax_segment_sum_f64
from spark_rapids_tpu_torch.exec.base import batch_vecs
from spark_rapids_tpu_torch.exec.joins import _probe_counts
from spark_rapids_tpu_torch.expr.hashing import hash_vecs
from spark_rapids_tpu_torch.ops import pallas_probe, pallas_segsum
from torch_port import port_batch


def _hash_table():  # tests/test_fusion.py:316-321
    return pa.table({
        "i": pa.array([None if i % 7 == 0 else int(i * 31 - 4000)
                       for i in range(300)], pa.int32()),
        "l": pa.array([None if i % 5 == 0 else int(i * 10**14 - 2**50)
                       for i in range(300)], pa.int64()),
    })


class TestMurmur3:
    def test_hash_parity_int_long_nullable(self):
        jb = jax_batch_from_arrow(_hash_table())
        jvecs = jax_batch_vecs(jb)
        ref = np.asarray(jax_hash_vecs(jnp, jvecs))
        ref_pallas = np.asarray(jax_pallas_probe.hash_vecs_pallas(jnp, jvecs))
        vecs = batch_vecs(port_batch(jb))
        assert (ref == ref_pallas).all()
        assert (hash_vecs(vecs).numpy() == ref).all()
        assert (pallas_probe.hash_vecs_pallas(vecs).numpy() == ref).all()

    def test_candidate_counts_match_probe_counts(self):
        # tests/test_fusion.py:327-347; the build is padded to the probe's
        # capacity so both JAX hashes share one interpret-mode compile
        rng = np.random.default_rng(3)
        jprobe = jax_batch_from_arrow(pa.table({
            "k": pa.array([None if i % 9 == 0 else int(v) for i, v in
                           enumerate(rng.integers(0, 50, 400))],
                          pa.int64())}))
        jbuild = jax_batch_from_arrow(pa.table({
            "k": pa.array([None if i % 6 == 0 else int(v) for i, v in
                           enumerate(rng.integers(0, 50, 80))],
                          pa.int64())}), capacity=jprobe.capacity)
        ref = np.asarray(jax_probe_counts.fn(jprobe, jbuild, (0,), (0,))[0])
        ref_pallas = np.asarray(jax_pallas_probe.candidate_counts(
            jnp, jax_batch_vecs(jprobe), jax_batch_vecs(jbuild),
            jprobe.row_mask(), jbuild.row_mask()))
        probe, build = port_batch(jprobe), port_batch(jbuild)
        got = pallas_probe.candidate_counts(
            batch_vecs(probe), batch_vecs(build), probe.row_mask(),
            build.row_mask()).numpy()
        plain = _probe_counts(probe, build, (0,), (0,))[0].numpy()
        assert (ref == ref_pallas).all()
        assert (got == ref).all() and (plain == ref).all()

    @pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
    def test_wrapper_takes_plain_twin_on_cpu(self, dtype):
        rng = np.random.default_rng(5)
        keys = torch.from_numpy(rng.integers(-2**31, 2**31, 1000)).to(dtype)
        valid = torch.from_numpy(rng.random(1000) > 0.2)
        seed = torch.from_numpy(rng.integers(-2**31, 2**31, 1000)
                                .astype(np.int32))
        before = pallas_probe.murmur3_rows.launches
        got = pallas_probe.murmur3_rows(keys, valid, seed)
        assert torch.equal(got, pallas_probe.murmur3_rows_plain(
            keys, valid, seed))
        assert torch.equal(got[~valid], seed[~valid])  # nulls pass the seed
        assert pallas_probe.murmur3_rows.launches == before

    def test_wrapper_rejects_other_devices_and_types(self):
        keys = torch.zeros(4, dtype=torch.int64)
        ok = torch.ones(4, dtype=torch.bool)
        seed = torch.zeros(4, dtype=torch.int32)
        with pytest.raises(ValueError):
            pallas_probe.murmur3_rows(keys.to("meta"), ok.to("meta"),
                                      seed.to("meta"))
        with pytest.raises(TypeError):
            pallas_probe.murmur3_rows(keys.double(), ok, seed)


def _segsum_cases():  # tests/test_pallas.py
    rng = np.random.default_rng(42)

    def rand(n, g, dist):
        return dist(n), rng.integers(0, g, n).astype(np.int32), g

    return {
        "positive": rand(50_000, 1024, lambda n: rng.uniform(0.5, 1.5, n)),
        "signed": rand(30_000, 700, lambda n: rng.normal(0, 100, n)),
        "one_row": rand(1, 1, lambda n: rng.uniform(size=n)),
        "ragged": rand(2049, 3, lambda n: rng.uniform(size=n)),
        "chunk": rand(4096, 128, lambda n: rng.uniform(size=n)),
        "out_of_range": (np.array([1.0, 2.0, 99.0, 77.0]),
                         np.array([0, 1, -1, 5], np.int32), 4),
        "beyond_f32": (np.array([1e300, 1.0, 2.0, 3.0]),
                       np.array([0, 1, 1, 2], np.int32), 4),
        "int64_ids": (np.array([5.0, 1.0]),
                      np.array([2**32 + 2, 0], np.int64), 4),
        "wide_range": (np.concatenate([np.full(100, 1e12),
                                       np.full(100, 1e-3)]),
                       np.zeros(200, np.int32), 1),
    }


def _contract(out, vals, ids, g):
    keep = (ids >= 0) & (ids < g)
    exact = np.bincount(ids[keep], weights=vals[keep], minlength=g)
    mass = np.bincount(ids[keep], weights=np.abs(vals[keep]),
                       minlength=g) + 1.0
    assert np.all(np.abs(out - exact) <= 1e-6 * mass)
    return exact


class TestSegmentSum:
    @pytest.mark.parametrize("case", sorted(_segsum_cases()))
    def test_matches_numpy_contract(self, case):
        vals, ids, g = _segsum_cases()[case]
        out = pallas_segsum.segment_sum_f64(
            torch.from_numpy(vals), torch.from_numpy(ids), g).numpy()
        exact = _contract(out, vals, ids, g)
        if case == "beyond_f32":
            assert out[0] == 1e300 and out.tolist() == exact.tolist()

    def test_matches_jax_kernel(self):
        cases = _segsum_cases()
        for case in ("positive", "int64_ids"):
            vals, ids, g = cases[case]
            ref = np.asarray(jax_segment_sum_f64(jnp.asarray(vals),
                                                 jnp.asarray(ids), g))
            out = pallas_segsum.segment_sum_f64(
                torch.from_numpy(vals), torch.from_numpy(ids), g).numpy()
            mass = np.bincount(np.clip(ids, 0, g), weights=np.abs(vals),
                               minlength=g + 1)[:g] + 1.0
            assert np.all(np.abs(out - ref) <= 1e-6 * mass), case

    def test_nan_confined_to_its_segment(self):
        out = pallas_segsum.segment_sum_f64(
            torch.tensor([np.nan, 1.0, 2.0], dtype=torch.float64),
            torch.tensor([0, 1, 2], dtype=torch.int32), 3).numpy()
        assert np.isnan(out[0]) and out[1] == 1.0 and out[2] == 2.0

    def test_rejects_oversized_segment_count(self):
        with pytest.raises(ValueError):
            pallas_segsum.segment_sum_f64(
                torch.zeros(8, dtype=torch.float64),
                torch.zeros(8, dtype=torch.int32),
                pallas_segsum.MAX_SEGMENTS + 1)


class TestSegmentSumGeometry:
    """The kernel's row split and grid (pallas_segsum.launch_geometry,
    step_rows), checked in pure Python: the CUDA kernel reads rows exactly
    as step_rows lists them."""

    @pytest.mark.parametrize("n, g", [
        (0, 1), (1, 1), (3, 4096), (63, 7), (64, 1024), (65, 4096),
        (1000, 3), (12_295, 1024), (262_151, 1), (300_007, 4096)])
    def test_every_row_has_exactly_one_owner(self, n, g):
        rows = pallas_segsum.step_rows(pallas_segsum.launch_geometry(n, g), n)
        live = rows[rows >= 0]
        assert live.size == n
        assert np.array_equal(np.sort(live), np.arange(n))

    def test_split_depends_only_on_rows_and_segments(self, monkeypatch):
        want = [pallas_segsum.launch_geometry(n, g)
                for n in (1, 4_194_304) for g in (1, 1024, 4096)]

        def no_card(*a, **k):
            raise AssertionError("the split asked about the card")

        for name in ("device_count", "get_device_properties",
                     "current_device", "is_available"):
            monkeypatch.setattr(torch.cuda, name, no_card)
        assert [pallas_segsum.launch_geometry(n, g)
                for n in (1, 4_194_304) for g in (1, 1024, 4096)] == want

    def test_fits_shared_memory_and_block_cap(self):
        limit = 227 * 1024  # shared memory one block may use on Hopper
        for g in range(1, pallas_segsum.MAX_SEGMENTS + 1):
            for n in (0, 1, 63, 65, 4097, 1_000_003, 4_194_304, 4_194_311):
                geom = pallas_segsum.launch_geometry(n, g)
                assert geom.smem_bytes == geom.warps * g * 9 <= limit
                assert 1 <= geom.warps <= pallas_segsum.MAX_WARPS
                assert 0 <= geom.blocks <= pallas_segsum.MAX_BLOCKS
                span = geom.warps * geom.units_per_warp * 64
                # every row is covered, and no block is left without rows
                assert geom.blocks * span >= n > (geom.blocks - 1) * span

    def test_bench_shape_is_one_wave(self):
        geom = pallas_segsum.launch_geometry(4_194_304, 1024)
        assert geom == pallas_segsum.Geometry(131, 24, 21, 221_184)
