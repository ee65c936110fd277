"""The port's 6x6 truncated-SVD solve (``ops/solve6``) against JAX's
``tracking._solve6``, and its kernel against its plain version on the card
(``tests/test_torch_kernels_cuda.py``, which runs where JAX is absent).

The bank (``solve6.system_bank``): seeded systems shaped like the
tracker's, well-conditioned (cond 1-1e3), ill-conditioned (cond within a
factor 2 of ``cond_thres``) and rank-3 (a bare wall's). Bounds, per
system (``solve6.disagreements``): ``degenerate`` equal, except where
cond is within 0.1% of ``cond_thres``; where not degenerate, ``|dx|inf <=
1e-6 cond max(1, |x|inf)`` and ``|dcond| <= max(1e-4, 1e-6 cond) cond``. Both sides of the
CPU test are f32 SVDs, whose smallest singular value is off by about
eps32 * s0: cond is then off by about eps32 * cond relative (measured up to
1e-3 relative at cond 2e4), and 1e-6 cond is some 20 times that. The card's
test (f64 Jacobi against the plain f32 SVD) uses the same bounds and holds
cond within 1e-4 relative of an f64 SVD.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from voxelhashing_tpu import tracking as jtr
from voxelhashing_tpu_torch.ops import solve6 as s6

COND_THRES = 2.0e4          # TrackerConfig.cond_thres
BANK = s6.system_bank(seed=7, n_per_kind=48, cond_thres=COND_THRES)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax(a, b):
    out = [jtr._solve6(jnp.asarray(a[i]), jnp.asarray(b[i]), COND_THRES)
           for i in range(a.shape[0])]
    return tuple(np.stack([np.asarray(o[k]) for o in out]) for k in range(3))


def _cond64(a):
    s = np.linalg.svd(a.astype(np.float64), compute_uv=False)
    return s[:, 0] / np.maximum(s[:, -1], 1e-20)


@pytest.mark.parametrize("kind", s6.BANK_KINDS)
def test_plain_matches_jax(kind):
    a, b, kinds = BANK
    sel = np.array([k == kind for k in kinds])
    a, b = a[sel], b[sel]
    ref = _jax(a, b)
    got = s6.solve6_plain(torch.from_numpy(a), torch.from_numpy(b),
                          COND_THRES)
    got = tuple(t.numpy() for t in got)
    assert not s6.disagreements(ref, got, _cond64(a), COND_THRES)
    # the bank holds what its kind says
    n_degen = int(ref[2].sum())
    assert n_degen == {"well": 0, "rank3": len(a)}.get(kind, n_degen)
    assert kind != "ill" or 0 < n_degen < len(a)


def test_batched_plain_is_each_system():
    a, b, _ = BANK
    a, b = torch.from_numpy(a[::9]), torch.from_numpy(b[::9])
    x, cond, degen = s6.solve6_plain(a, b, COND_THRES)
    for i in range(a.shape[0]):
        xi, ci, di = s6.solve6_plain(a[i], b[i], COND_THRES)
        assert torch.equal(x[i], xi) and torch.equal(cond[i], ci)
        assert bool(degen[i]) == bool(di)


@pytest.mark.parametrize("bad", [np.nan, np.inf])
def test_non_finite_system_is_degenerate_as_in_jax(bad):
    a, b, _ = BANK
    a, b = a[0].copy(), b[0]
    a[2, 4] = bad
    jx, jc, jd = (np.asarray(v) for v in jtr._solve6(
        jnp.asarray(a), jnp.asarray(b), COND_THRES))
    x, cond, degen = s6.solve6_plain(torch.from_numpy(a),
                                     torch.from_numpy(b), COND_THRES)
    assert bool(jd) and bool(degen)
    np.testing.assert_array_equal(x.numpy(), jx)
    assert np.all(jx == 0.0)
    assert np.isnan(float(cond)) and np.isnan(jc)


def test_solve_on_the_cpu_is_the_plain_version():
    """``solve6`` on CPU tensors is ``solve6_plain``, bit for bit, on a
    strided [6,6] view of an [8,8] system as the tracker passes it, and
    launches nothing; the tracker's update (``ops/icp_update``) solves
    with ``solve6_plain`` on the CPU."""
    a, b, _ = BANK
    m = torch.zeros((8, 8))
    m[:6, :6] = torch.from_numpy(a[3])
    launches = s6.solve6.launches
    got = s6.solve6(m[:6, :6], torch.from_numpy(b[3]), COND_THRES)
    ref = s6.solve6_plain(torch.from_numpy(a[3]), torch.from_numpy(b[3]),
                          COND_THRES)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))
    assert s6.solve6.launches == launches
    assert s6.solve6_plain.cuda_calls == 0


def test_wrapper_checks_and_arguments():
    """The wrapper's checks and launch arguments, which run on the CPU:
    strides of a view, the batch, and refusals."""
    m = torch.zeros((8, 8))
    args, (x, cond, degen) = s6.prepare(m[:6, :6], m[6, :6], COND_THRES)
    _, _, a_bs, a_rs, b_bs, thres, *_, n_sys, dev = args
    assert (a_bs, a_rs, b_bs, n_sys) == (0, 8, 0, 1)
    assert thres == COND_THRES and dev == m.device
    assert x.shape == (6,) and cond.shape == () and degen.dtype == torch.bool
    args, (x, cond, _) = s6.prepare(torch.zeros((5, 6, 6)),
                                    torch.zeros((5, 6)), COND_THRES)
    assert args[2:5] == (36, 6, 6) and args[-2] == 5
    assert x.shape == (5, 6) and cond.shape == (5,)
    for a, b in ((torch.zeros((6, 6), dtype=torch.float64), torch.zeros(6)),
                 (torch.zeros((5, 5)), torch.zeros(5)),
                 (torch.zeros((6, 6)), torch.zeros(7)),
                 (torch.zeros((6, 12))[:, ::2], torch.zeros(6))):
        with pytest.raises(ValueError):
            s6.prepare(a, b, COND_THRES)
    with pytest.raises(ValueError):
        s6.solve6(torch.zeros((6, 6), device="meta"),
                  torch.zeros(6, device="meta"), COND_THRES)


def test_bytes_and_operations():
    assert s6.bytes_moved(18) == 18 * (144 + 24 + 24 + 4 + 1)
    assert s6.operations([6]) == 15 * (s6._OPS_PER_GATE * 6
                                       + s6._OPS_PER_ROTATION * 5) \
        + s6._OPS_PER_SYSTEM
    assert s6.operations([6, 0]) == s6.operations([6]) + 15 * \
        s6._OPS_PER_GATE + s6._OPS_PER_SYSTEM
