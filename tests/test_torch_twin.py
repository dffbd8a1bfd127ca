"""The port's plain twin-CDT search against the Pallas kernel (interpret
mode under jax.jit, as tests/test_twin_pallas.py runs it) and the host
binary search, on the same boundary draws; and the device resolve against
the host CDF walk.  Exact equality."""

import numpy as np
import pytest
import torch

import jax

from ringo_tpu import backend  # noqa: F401  (x64 before tracing)
from ringo_tpu.csprng.gaussian import TwinCDTDevice as RefDevice
from ringo_tpu.csprng.gaussian import TwinCDTGaussianSampler
from ringo_tpu.ops.twin_pallas import TwinSearchPallas
from ringo_tpu_torch.csprng import gaussian


def _lanes(host, n=5000, seed=3):
    rng = np.random.default_rng(seed)
    c0 = rng.integers(0, 128, n).astype(np.int32)
    c1 = rng.integers(0, 128, n).astype(np.int32)
    c1[:50] = c0[:50]
    u = rng.integers(0, 1 << 63, n).astype(np.uint64) * 2 + 1
    u[:4] = [0, 1, (1 << 64) - 1, host.tables[5][10]]
    u[4] = host.tables[7][3] + 1
    u[5] = host.tables[7][3] - 1
    u[6] = (host.tables[9][2] >> np.uint64(40)) << np.uint64(40)
    return c0, c1, u


def _port_search(dev, c0, c1, u):
    v0, v1 = dev.twin_search(torch.from_numpy(c0), torch.from_numpy(c1),
                             torch.from_numpy(u.view(np.int64)))
    return v0.numpy(), v1.numpy()


def test_plain_search_matches_pallas_and_host():
    sigma = 12.000331
    host = TwinCDTGaussianSampler(sigma, b"s")
    c0, c1, u = _lanes(host)
    ps = TwinSearchPallas(RefDevice(sigma))
    r0, r1 = jax.jit(lambda a, b, c: ps(a, b, c, interpret=True))(c0, c1, u)
    v0, v1 = _port_search(gaussian.TwinCDTDevice(sigma, "cpu"), c0, c1, u)
    np.testing.assert_array_equal(v0, np.asarray(r0))
    np.testing.assert_array_equal(v1, np.asarray(r1))
    np.testing.assert_array_equal(v0, host._bsearch(c0.astype(np.int64), u))
    np.testing.assert_array_equal(v1, host._bsearch(c1.astype(np.int64), u))


@pytest.mark.parametrize("sigma", [4.787466224214409, 6.770275002573077])
def test_commit_sigmas_match_host(sigma):
    host = TwinCDTGaussianSampler(sigma, b"s")
    c0, c1, u = _lanes(host, n=20000, seed=int(sigma))
    v0, v1 = _port_search(gaussian.TwinCDTDevice(sigma, "cpu"), c0, c1, u)
    np.testing.assert_array_equal(v0, host._bsearch(c0.astype(np.int64), u))
    np.testing.assert_array_equal(v1, host._bsearch(c1.astype(np.int64), u))


def test_search_and_resolve_match_host_sampler():
    """search + resolve_device on the port == the host twin-CDT sampler's
    outcome for the same draws (reference gaussian_twin_cdt.go)."""
    sigma = 4.787466224214409
    rng = np.random.default_rng(11)
    n = 40000
    centers = rng.normal(0, 3000, n)
    u = rng.integers(0, 1 << 63, n).astype(np.uint64) * 2 + 1
    host = TwinCDTGaussianSampler(sigma, b"s")
    dev = gaussian.TwinCDTDevice(sigma, "cpu")
    tu = torch.from_numpy(u.view(np.int64))
    prov, agree, c_floor, c_frac, v0, v1 = dev.search(
        torch.from_numpy(centers), tu)
    bad = torch.nonzero(~agree)[:, 0]
    assert 0 < len(bad) < n // 10
    fix = dev.resolve_device(c_frac[bad], tu[bad], v0[bad], v1[bad],
                             c_floor[bad])
    out = prov.clone()
    out[bad] = fix
    # host sampler semantics on the same (center, u) lanes
    cf = np.floor(centers)
    frac = centers - cf
    h0 = host._bsearch((np.floor(128 * frac).astype(np.int64)) % 128, u)
    h1 = host._bsearch((np.ceil(128 * frac).astype(np.int64)) % 128, u)
    want = h0 + cf.astype(np.int64) + host.tail_lo
    hb = h0 != h1
    res = gaussian.twin_cdt_resolve(sigma, host.tail_lo, host.tail_hi,
                                    frac[hb], u[hb], h0[hb], h1[hb])
    want[hb] = res + host.tail_lo + cf[hb].astype(np.int64)
    np.testing.assert_array_equal(out.numpy(), want)


def test_cuda_wrapper_refuses_cpu_tensors():
    dev = gaussian.TwinCDTDevice(4.787466224214409, "cpu")
    z = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        gaussian.twin_search_cuda(dev.tables_raw, z, z,
                                  torch.zeros(4, dtype=torch.int64))


def test_host_samplers_match_reference():
    """The port's numpy copies of the host samplers draw exactly what the
    JAX package's draw, from the same seeds."""
    from ringo_tpu.csprng import COSACSampler, RoundedGaussianSampler
    from ringo_tpu_torch.csprng import gaussian as pg

    rng = np.random.default_rng(9)
    centers = rng.normal(0, 1000, 3000)
    sigmas = rng.uniform(2.0, 5000.0, 3000)
    np.testing.assert_array_equal(
        pg.COSACSampler(b"co", device="cpu").sample(centers, sigmas),
        COSACSampler(b"co").sample(centers, sigmas))
    np.testing.assert_array_equal(
        pg.RoundedGaussianSampler(b"rg", device="cpu").sample(0.0, 2455.3, 5000),
        RoundedGaussianSampler(b"rg").sample(0.0, 2455.3, 5000))
    np.testing.assert_array_equal(
        pg.TwinCDTGaussianSampler(4.787466224214409, b"tc", device="cpu").sample(centers),
        TwinCDTGaussianSampler(4.787466224214409, b"tc").sample(centers))
    from ringo_tpu.csprng import compute_cdt

    for c in (0.0, 0.25, 0.999):
        np.testing.assert_array_equal(pg.compute_cdt(c, 6.77),
                                      compute_cdt(c, 6.77))
