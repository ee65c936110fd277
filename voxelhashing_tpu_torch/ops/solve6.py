"""The tracker's 6x6 truncated-SVD solve (``csrc/solve6.cu``).

No TPU kernel: the JAX package solves the system with ``jnp.linalg.svd``
inside its XLA program (``voxelhashing_tpu/tracking.py:339``). On CUDA,
``torch.linalg.svd`` reads the device on the host twice a call, which
also keeps a step out of a CUDA graph; the kernel's core (two-sided
Jacobi on the f64 Gram matrix, one thread a system) solves with no host
read. The tracker runs that core inside its ICP update
(``ops/icp_update.py``, one launch a solve); :func:`solve6` is the batched
entry point over the same core, for the checks and the system bank, and
no path of the port calls it.

:func:`solve6` launches the kernel for CUDA tensors and runs the plain
version, :func:`solve6_plain`, for CPU tensors; any other device raises.
There is no fallback from the kernel to the plain version, and the plain
version counts its calls on CUDA tensors (``solve6_plain.cuda_calls``).
Each kernel launch adds one to ``solve6.launches``, whatever the batch.

Both return ``(x f32[...,6], cond f32[...], degenerate bool[...])`` for
``a`` f32 ``[6,6]`` or ``[B,6,6]`` and ``b`` f32 ``[6]`` or ``[B,6]``.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build

N = 6
# bytes of one system: a and b read, x, cond and degenerate written
BYTES_PER_SYSTEM = 4 * N * N + 4 * N + 4 * N + 4 + 1
# f64 operations (counted on csrc/solve6.cu with adds, multiplies,
# divisions, square roots and compares one each): per system the Gram
# matrix's 21 entries and a^T b (27 * 12), its trace (6), and after the
# sweeps the values (6 * 4), the cut (2) and x (6 * 25); per pair and
# sweep the gate (6); per rotation the angle (14) and the updates of the
# four other rows of G (4 * 6), its pair (4) and of V's two columns (6 * 6)
_OPS_PER_SYSTEM = 27 * 12 + 6 + 6 * 4 + 2 + 6 * 25
_OPS_PER_GATE = 6
_OPS_PER_ROTATION = 14 + 4 * 6 + 4 + N * 6


def bytes_moved(n_systems: int) -> int:
    """The least bytes a batch must move: each input read once, each output
    written once."""
    return BYTES_PER_SYSTEM * n_systems


def operations(sweeps) -> int:
    """The f64 operations of systems that ran ``sweeps`` Jacobi sweeps each
    (an iterable of counts): every sweep tests the 15 pairs, and every
    sweep but the last rotates at most 15 (counted as 15)."""
    sweeps = [max(int(s), 1) for s in sweeps]
    pairs = N * (N - 1) // 2
    return sum(pairs * (_OPS_PER_GATE * s + _OPS_PER_ROTATION * (s - 1))
               + _OPS_PER_SYSTEM for s in sweeps)


BANK_KINDS = ("well", "ill", "rank3")


def system_bank(seed: int, n_per_kind: int, cond_thres: float):
    """Seeded f32 systems shaped like the tracker's, for holding the kernel
    and its plain version against each other: ``a = Q diag(s) Q^T`` with a
    random rotation Q and s0 in [1e-2, 1e4], perturbed by 1e-7 relative
    noise per entry (symmetric only up to rounding, as a sum of f32
    products is), and ``b`` ~ s0. Kinds, ``n_per_kind`` each:
    ``"well"`` cond in [1, 1e3]; ``"ill"`` cond in [0.5, 2] x
    ``cond_thres``; ``"rank3"`` a bare wall's system, three singular values
    at ~1e-9 s0. Returns (a [B,6,6], b [B,6], kinds [B]) as numpy."""
    rng = np.random.default_rng(seed)
    a_out, b_out, kinds = [], [], []
    for kind in BANK_KINDS:
        for _ in range(n_per_kind):
            q, _ = np.linalg.qr(rng.standard_normal((N, N)))
            s0 = 10 ** rng.uniform(-2, 4)
            if kind == "rank3":
                s = np.concatenate([s0 * 10 ** rng.uniform(-1.5, 0, 3),
                                    s0 * 1e-9 * rng.uniform(0, 1, 3)])
            else:
                cond = (10 ** rng.uniform(0, 3) if kind == "well"
                        else cond_thres * 10 ** rng.uniform(-0.3, 0.3))
                s = s0 * np.exp(np.sort(rng.uniform(-np.log(cond), 0,
                                                    N))[::-1])
                s[0], s[-1] = s0, s0 / cond
            a = (q * s) @ q.T
            a = a + a * rng.standard_normal((N, N)) * 1e-7
            a_out.append(a.astype(np.float32))
            b_out.append((rng.standard_normal(N) * s0).astype(np.float32))
            kinds.append(kind)
    return np.stack(a_out), np.stack(b_out), kinds


def disagreements(ref, got, cond_ref, cond_thres: float):
    """The systems where ``got`` = (x, cond, degenerate) leaves the bounds
    around ``ref`` (numpy arrays [B,6], [B], [B]), as a list of (index,
    what, values). ``cond_ref`` [B] (an f64 SVD's) decides which systems
    sit at the threshold: within 0.1% of ``cond_thres`` nothing is held.
    Elsewhere ``degenerate`` is equal, x is 0 where it is set, and
    otherwise ``|dx|inf <= 1e-6 cond max(1, |x|inf)`` and ``|dcond| <=
    max(1e-4, 1e-6 cond) cond``: an f32 SVD's smallest singular value is
    off by about eps32 * s0, so its cond by about eps32 * cond relative."""
    (xr, _, dr), (xg, cg, dg) = ref, got
    bad = []
    for i in range(len(dr)):
        if abs(cond_ref[i] - cond_thres) <= 1e-3 * cond_thres:
            continue
        if bool(dr[i]) != bool(dg[i]):
            bad.append((i, "degenerate", dr[i], dg[i]))
            continue
        if dr[i]:
            if np.any(xg[i] != 0.0):
                bad.append((i, "x of a degenerate system", xg[i]))
            continue
        c = float(cond_ref[i])
        dx = float(np.max(np.abs(xg[i] - xr[i])))
        if not dx <= 1e-6 * c * max(1.0, float(np.max(np.abs(xr[i])))):
            bad.append((i, "x", dx, c))
        if not abs(float(cg[i]) - c) <= max(1e-4, 1e-6 * c) * c:
            bad.append((i, "cond", float(cg[i]), c))
    return bad


def solve6_plain(a, b, cond_thres: float):
    """Truncated-SVD solve of the 6x6 system with the condition gate
    (``torch.linalg.svd``; one system, or a batch solved one by one).
    A non-finite ``a`` is degenerate (x = 0, cond NaN, as in JAX):
    ``torch.linalg.svd`` refuses such input, so it sees zeros there."""
    if a.device.type == "cuda":
        solve6_plain.cuda_calls += 1
    if a.ndim == 3:
        outs = [solve6_plain(a[i], b[i], cond_thres)
                for i in range(a.shape[0])]
        return tuple(torch.stack(t) for t in zip(*outs))
    finite = torch.all(torch.isfinite(a))
    u, s, vt = torch.linalg.svd(torch.where(finite, a, 0.0),
                                full_matrices=False)
    cond = s[0] / torch.clamp(s[5], min=1e-20)
    degenerate = (s[0] <= 0.0) | (cond > cond_thres) | ~finite
    s_min = torch.clamp(s[0] / cond_thres, min=1e-10)
    s_inv = torch.where(s > s_min, 1.0 / s, 0.0)
    x = vt.T @ (s_inv * (u.T @ b))
    return (torch.where(degenerate, 0.0, x),
            torch.where(finite, cond, torch.nan), degenerate)


solve6_plain.cuda_calls = 0


def _check_inputs(a, b):
    batch = tuple(a.shape[:-2])
    checks = [
        (a.dtype == torch.float32 and b.dtype == torch.float32,
         "a and b must be f32"),
        (a.ndim in (2, 3) and tuple(a.shape[-2:]) == (N, N),
         "a must be [6,6] or [B,6,6]"),
        (tuple(b.shape) == batch + (N,), "b must be [6] or [B,6] like a"),
        (a.stride(-1) == 1 and b.stride(-1) == 1,
         "the last dimension of a and b must be contiguous"),
        (a.device == b.device, "a and b on one device"),
    ]
    for ok, msg in checks:
        if not ok:
            raise ValueError(f"solve6: {msg}")


def prepare(a, b, cond_thres: float, sweeps=None):
    """Check the inputs and allocate the outputs; returns (launch
    arguments, (x, cond, degenerate)). ``sweeps``: an int32 [B] tensor that
    takes each system's Jacobi sweeps (measurement only)."""
    _check_inputs(a, b)
    batch = tuple(a.shape[:-2])
    n_sys = batch[0] if batch else 1
    dev = a.device
    x = torch.empty(batch + (N,), dtype=torch.float32, device=dev)
    cond = torch.empty(batch, dtype=torch.float32, device=dev)
    degen = torch.empty(batch, dtype=torch.bool, device=dev)
    a_bs = a.stride(0) if batch else 0
    b_bs = b.stride(0) if batch else 0
    p = _build.ptr
    args = (p(a), p(b), a_bs, a.stride(-2), b_bs, float(cond_thres), p(x),
            p(cond), p(degen), _build.ptr_or_null(sweeps), n_sys, dev)
    return args, (x, cond, degen)


def launch(args) -> None:
    """Launch the kernel on prepared arguments, on the current stream (the
    only place that does; counts the launch)."""
    *kernel_args, device = args
    _build.check(_build.library("solve6").vh_solve6(
        *kernel_args, _build.stream_ptr(device)), "solve6")
    solve6.launches += 1


def solve6(a, b, cond_thres: float):
    """(x, cond, degenerate) of the 6x6 system(s) ``a x = b``: the kernel on
    CUDA tensors, :func:`solve6_plain` on CPU tensors."""
    if a.device.type == "cpu":
        return solve6_plain(a, b, cond_thres)
    if a.device.type != "cuda":
        raise ValueError(f"solve6: no kernel for {a.device}")
    args, out = prepare(a, b, cond_thres)
    launch(args)
    return out


solve6.launches = 0
