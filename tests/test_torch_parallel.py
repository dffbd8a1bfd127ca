"""The port's multi-device layer (ringo_tpu_torch/parallel) on
``torch.distributed`` with gloo on the CPU, against the port on one device:
every sharded program gives the same bytes.  The counterpart of the JAX
package's tests/test_parallel.py and tests/test_multihost.py.

One module-scoped ``torch.multiprocessing.spawn`` of world size 2 (a
FileStore under the test's temporary directory) runs every case of
tests/torch_parallel_cases.py on the meshes (2, 1, 1), (1, 2, 1) and
(1, 1, 2) in turn: each axis split two ways, the others whole.  Each
(case, mesh) is a test, holding both ranks' results to the single-device
run.  All comparisons are exact."""

import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import torch_parallel_cases as cases
from ringo_tpu_torch import parallel as P
from ringo_tpu_torch.fields import ZP128, ZP255
from ringo_tpu_torch.rings.bigring import CyclotomicRing

WORLD = 2


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """([{mesh shape: results} of each rank of the world-size-2 run], the
    single-device results), the latter computed while the ranks run."""
    d = tmp_path_factory.mktemp("world2")
    out = str(d / "results")
    ctx = mp.spawn(cases.worker, args=(WORLD, str(d / "store"), out),
                   nprocs=WORLD, join=False)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        single = cases.single()
    finally:
        torch.set_num_threads(n)
    while not ctx.join():
        pass
    return ([torch.load(f"{out}.{r}", weights_only=False)
             for r in range(WORLD)], single)


def _equal(got, want):
    if isinstance(want, torch.Tensor):
        assert isinstance(got, torch.Tensor) and got.dtype == want.dtype
        assert torch.equal(got, want)
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _equal(g, w)
    else:
        assert got == want


def _direct_dft(spec, vals, root, inverse=False):
    p, n = spec.p, len(vals)
    if inverse:
        root = pow(root, p - 2, p)
    pw = [1] * n
    for i in range(1, n):
        pw[i] = pw[i - 1] * root % p
    out = [sum(vals[i] * pw[(i * k) % n] for i in range(n)) % p
           for k in range(n)]
    return [pow(n, p - 2, p) * v % p for v in out] if inverse else out


def test_mesh_factoring():
    assert P.mesh_shape(8) == (2, 2, 2)
    assert P.mesh_shape(4) == (2, 2, 1)
    assert P.mesh_shape(2) == (2, 1, 1)
    assert P.mesh_shape(1) == (1, 1, 1)
    assert P.mesh_shape(6) == (2, 3, 1)


def test_single_process_helpers():
    """Without a process group a mesh cannot be made; one process makes a
    world of one, where the broadcast is the identity and the barrier
    returns; a mesh refuses a world of another size and tensors on
    another kind of device."""
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError):
        P.make_mesh(device="cpu")
    try:
        assert P.init_multihost(device="cpu") == 0
        assert P.bcast_bytes(b"challenge!", 10) == b"challenge!"
        P.sync_global_devices("t")
        mesh = P.make_mesh(device="cpu")
        assert tuple(mesh.shape) == (1, 1, 1)
        with pytest.raises(ValueError):
            P.make_mesh(2, device="cpu")
        sh = P.ShardedBigNTT(ZP128, 256, mesh, n1=16)
        with pytest.raises(ValueError):
            sh.fwd(torch.zeros((ZP128.w, 256), dtype=torch.int64,
                               device="meta"))
        with pytest.raises(ValueError):
            P.ShardedBigNTT(ZP128, 256, mesh, n1=16, device="meta")
        with pytest.raises(ValueError):              # cyclic rings only
            CyclotomicRing(ZP128, 256, device="cpu").shard(mesh)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("shape", cases.MESHES, ids=str)
@pytest.mark.parametrize("case", cases.CASES)
def test_sharded_case_equals_one_device(runs, case, shape):
    sharded, single = runs
    for rank, res in enumerate(sharded):
        got = res[shape][case]
        if case in ("commit", "commit_uneven", "evaluate", "buckler_round"):
            _equal(got, single[case])
        elif case in ("dft_stage", "dft_matmul"):
            spec = ZP128 if case == "dft_stage" else ZP255
            vals = cases.dft_input(spec)
            assert got["engine"] == ("BigNTTDev" if case == "dft_stage"
                                     else "MatmulBigNTT")
            assert got["fwd"] == _direct_dft(spec, vals, got["root"])
            assert got["inv"] == _direct_dft(spec, vals, got["root"], True)
            assert got["back"] == vals
        elif case in ("buckler_prove", "jindo_roundtrip"):
            assert got == single[case]
            assert got["ok"] is True and got["bad"] is False
        elif case == "bcast":
            assert got == cases.PAYLOAD
        else:
            assert got is True, rank
