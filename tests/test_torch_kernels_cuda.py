"""The port's kernel wrappers: dispatch and build checks that run on the
CPU, and kernel-vs-plain checks that need an NVIDIA GPU (marked ``cuda``;
they skip without one). On a machine with a card:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Tolerance on the card: bit-equal (the kernels are built with -fmad=false
and follow the plain versions' operation order), but for the 6x6 solve
(``solve6.disagreements``: an f64 Jacobi against the plain version's f32
SVD) and the ICP update around it (``icp_update.disagreements``: that
bound on x and cond, the flags, counts and residuals equal, delta within
4e-6 plus the solve's difference carried through the pose), and the
tracker's pass kernels, whose association, mean and inv_std are
bit-equal and whose sums are held by ``icp_linearize.disagreements``
((1.01 n + 3) 2^-24 of the sum of the terms' absolute values; an f64
sum in a fixed order against cuBLAS's f32 product), counts equal; their
fused launch equals the split pair, and their depth sums the numpy model
of their order (``icp_sum_order.summed_in_kernel_order``), bit for bit.
``engine.make_step``'s graphs on the card are bit-equal to the eager step
and read the host twice a tracked frame. The file imports only the port,
so it runs where the JAX package cannot.
"""

import dataclasses

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from voxelhashing_tpu_torch import blockmap, geometry as geom
from voxelhashing_tpu_torch import integrate as integ
from voxelhashing_tpu_torch.config import CameraConfig, MapConfig
from voxelhashing_tpu_torch.io.synthetic import (Scene, make_trajectory,
                                                 render_depth)
from voxelhashing_tpu_torch.ops import _build
from voxelhashing_tpu_torch.ops import fused_integrate as fa, splat_zbuf as sb
from voxelhashing_tpu_torch.ops.fused_integrate import fused_integrate
from voxelhashing_tpu_torch.ops.splat_zbuf import (splat_color_plain,
                                                   splat_zbuf,
                                                   splat_zbuf_color,
                                                   splat_zbuf_plain)

import icp_sum_order

CAM = CameraConfig(width=128, height=96, fx=104.0, fy=104.0, cx=63.5,
                   cy=47.5)
CFG = MapConfig(voxel_size=0.02, truncation=0.06, truncation_scale=0.01,
                num_blocks=4096, table_size=16384, max_active_blocks=4096)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda", 0)


def _scene_state(device):
    """A map after two plain fusions, the next frame, and its active list."""
    poses = make_trajectory(4)
    state = blockmap.create(CFG, device)
    for i in (0, 3):
        d, c = render_depth(poses[i], CAM, Scene(), noise_sigma=0.002,
                            seed=i, device=device)
        pose = torch.from_numpy(poses[i]).to(device)
        state, _ = integ.allocate_from_depth(state, d, pose, CAM, CFG)
        aidx, n, _ = blockmap.compactify(state, geom.invert_rigid(pose), CAM,
                                         CFG)
        if i == 0:
            state, _ = _plain_integrate(state, d, c, pose, aidx, n)
    return state, d, c, pose, aidx, n


def _plain_integrate(state, d, c, pose, aidx, n):
    mask = torch.arange(aidx.shape[0], device=aidx.device) < n
    return integ.integrate(state, d, c, pose, CAM, CFG, active_idx=aidx,
                           active_mask=mask)


def _clone(state):
    return type(state)(*(t.clone() for t in state))


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _int_bits(t):
    """``t``'s bits as integers (NaNs compare equal by their bits)."""
    return t.view(torch.int32) if t.dtype == torch.float32 else _bits(t)


def test_wrappers_refuse_other_devices():
    """A tensor on neither the CPU nor CUDA is refused, never computed by
    the plain version."""
    meta = torch.device("meta")
    state = blockmap.create(CFG, meta)
    aidx = torch.zeros(8, dtype=torch.int32, device=meta)
    depth = torch.zeros(CAM.height, CAM.width, device=meta)
    with pytest.raises(ValueError, match="no kernel"):
        fused_integrate(state, depth, None, torch.eye(4, device=meta), CAM,
                        CFG, aidx, torch.zeros((), dtype=torch.int32,
                                               device=meta))
    mask = torch.zeros(8, dtype=torch.bool, device=meta)
    with pytest.raises(ValueError, match="no kernel"):
        splat_zbuf(state, aidx, mask, torch.eye(4, device=meta), CAM, CFG)
    with pytest.raises(ValueError, match="no kernel"):
        splat_zbuf_color(state, aidx, mask, torch.eye(4, device=meta), CAM,
                         CFG)
    from voxelhashing_tpu_torch.config import FilterConfig
    from voxelhashing_tpu_torch.ops import alloc_candidates as ac
    from voxelhashing_tpu_torch.ops import preprocess as pp
    with pytest.raises(ValueError, match="no kernel"):
        pp.preprocess_depth(depth, None, CAM, FilterConfig())
    with pytest.raises(ValueError, match="no kernel"):
        ac.alloc_candidates(depth, torch.eye(4, device=meta), CAM, CFG,
                            tile=4, phase=1)


def test_bilinear_caps_variant_source():
    """``bilinear_caps`` bounds only the bilinear instantiation's CTAs an
    SM, in the one ``__launch_bounds__`` of kernel A's source, and builds
    the source as it is for None."""
    from voxelhashing_tpu_torch import bilinear_caps
    src = (_build.CSRC / "fused_integrate.cu").read_text()
    assert bilinear_caps.variant_source(None) == src
    capped = bilinear_caps.variant_source(9)
    assert "__launch_bounds__(kRowThreads, kBilinear ? 9 : 1)" in capped
    assert capped.replace("kRowThreads, kBilinear ? 9 : 1",
                          "kRowThreads") == src


def test_kernel_probes_edits_apply():
    """Every edit ``kernel_probes`` makes finds its place once in the
    march's (and the tile bounds'), the insert's, GC's and the two front
    kernels' sources, and each build differs from the source as it is (but
    "as is")."""
    from voxelhashing_tpu_torch import kernel_probes as kp
    march = (_build.CSRC / "raymarch.cu").read_text()
    insert = (_build.CSRC / "hash_alloc.cu").read_text()
    for name, edits, _ in kp.MARCH_EDITS:
        assert (kp._edit(march, edits) == march) == (name == "as is"), name
    assert kp.march_clocked(march).count("clock64()") == 4
    assert kp.insert_clocked(insert).count("clock64()") == 6
    pre = (_build.CSRC / "preprocess.cu").read_text()
    cand = (_build.CSRC / "alloc_candidates.cu").read_text()
    for name, edits, _, _ in kp.PREPROCESS_EDITS:
        assert (kp._edit(pre, edits) == pre) == (name == "as is"), name
    for name, edits, _, launch in kp.CANDIDATE_EDITS:
        # a move made in the launch alone keeps the source
        assert (kp._edit(cand, edits) == cand) == (not edits), name
        assert bool(edits or launch) == (name != "as is"), name
    assert kp.front_clocked(pre, "preprocess").count("clock64()") == 5
    assert kp.front_clocked(cand, "candidates").count("clock64()") == 5
    delete = (_build.CSRC / "hash_delete.cu").read_text()
    for name, edits, _, launch in kp.BOUNDS_EDITS:
        # the fill is undone in the launch alone and keeps the source
        assert (kp._edit(march, edits) == march) == (not edits), name
        assert bool(edits or launch) == (name != "as is"), name
    for name, edits, _ in kp.GC_EDITS:
        assert (kp._edit(delete, edits) == delete) == (name == "as is"), name
    assert kp.bounds_clocked(march).count("clock64()") == 6
    assert kp.gc_clocked(delete).count("clock64()") == 7


def test_prime_runs_every_occupancy_query(monkeypatch):
    """``_build.prime`` (run before a CUDA graph capture) loads every
    library and calls each kernel's ``*_grid`` query."""
    called = []

    class Lib:
        def __getattr__(self, fn):
            return lambda: called.append(fn)

    monkeypatch.setattr(_build, "library", lambda name: Lib())
    _build.prime()
    assert sorted(called) == sorted(
        fn for fns in _build._SIGNATURES.values() for fn in fns
        if fn.endswith("_grid"))
    assert len(called) == 11


def _c_entry_points():
    """{name: [ctypes type, ...]} of every ``extern "C"`` function of
    ``csrc/*.cu`` from its declaration (a pointer, int, float or long
    long a parameter)."""
    import ctypes
    import re
    kinds = (("*", ctypes.c_void_p), ("long long", ctypes.c_longlong),
             ("float", ctypes.c_float), ("int", ctypes.c_int))
    out = {}
    for src in _build.sources():
        text = src.read_text()
        macros = {m: body.replace("\\\n", " ") for m, body in re.findall(
            r"#define (VH_\w+_ARGS)((?:.*\\\n)*.*)", text)}
        for name, params in re.findall(
                r'extern "C" int (vh_\w+)\(([^)]*)\)', text):
            params = macros.get(params.strip(), params)
            types = []
            for param in filter(None, (q.strip() for q in params.split(","))):
                types.append(next(t for k, t in kinds if k in param))
            out[name] = types
    return out


def test_signatures_match_the_c_entry_points():
    """Every entry point ``_build`` binds takes the argument types its C
    declaration names, in order (a missing or misread one makes ctypes
    refuse the call, or cut a pointer, only on the card)."""
    decl = _c_entry_points()
    bound = {fn: types for fns in _build._SIGNATURES.values()
             for fn, types in fns.items()}
    assert {"vh_hash_gc", "vh_hash_delete", "vh_ray_bounds"} <= set(bound)
    for fn, types in bound.items():
        assert decl[fn] == list(types), fn


def test_missing_nvcc_raises(monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()
    assert _build.library_path("splat_zbuf").name.startswith(
        "libvhtorch_splat_zbuf_")
    assert {s.stem for s in _build.sources()} == {
        "alloc_candidates", "fused_integrate", "hash_alloc", "hash_delete",
        "icp_linearize", "preprocess", "raymarch", "solve6", "splat_zbuf",
        "trace_stamp"}
    assert "-fmad=false" in _build.NVCC_FLAGS


@pytest.mark.cuda
def test_fused_integrate_kernel_bit_equal(cuda):
    state, d, c, pose, aidx, n = _scene_state(cuda)
    before = fused_integrate.launches
    sk, (mn_k, mx_k) = fused_integrate(_clone(state), d, c, pose, CAM, CFG,
                                       aidx, n)
    sp, (mn_p, mx_p) = _plain_integrate(_clone(state), d, c, pose, aidx, n)
    torch.cuda.synchronize()
    assert fused_integrate.launches == before + 1
    for f in ("sdf", "weight", "color", "surf"):
        assert torch.equal(_bits(getattr(sk, f)), _bits(getattr(sp, f))), f
    assert torch.equal(mn_k, mn_p) and torch.equal(mx_k, mx_p)
    assert bool((sk.weight != state.weight).any())
    # inputs the kernel would read out of bounds are refused
    with pytest.raises(ValueError, match="color"):
        fused_integrate(_clone(state), d, c[:-1], pose, CAM, CFG, aidx, n)
    with pytest.raises(ValueError, match="one device"):
        fused_integrate(_clone(state), d, c, pose.cpu(), CAM, CFG, aidx, n)
    assert fused_integrate.launches == before + 1


@pytest.mark.cuda
def test_splat_zbuf_kernel_bit_identical(cuda):
    state, _, _, pose, aidx, n = _scene_state(cuda)
    mask = torch.arange(aidx.shape[0], device=cuda) < n
    has_surf = state.surf[aidx.long()] & mask
    view = geom.invert_rigid(pose)
    before = splat_zbuf.launches
    zk = splat_zbuf(state, aidx, has_surf, view, CAM, CFG)
    zp, _ = splat_zbuf_plain(state, aidx, has_surf, view, CAM, CFG)
    torch.cuda.synchronize()
    assert splat_zbuf.launches == before + 1
    assert torch.equal(zk.view(torch.int32), zp.view(torch.int32))
    assert int(torch.isfinite(zk).sum()) > 1000
    np.testing.assert_array_equal(torch.isinf(zk).cpu().numpy(),
                                  torch.isinf(zp).cpu().numpy())


def _with_tie(state, aidx, n, has_surf):
    """A copy of ``state`` in which the surface row with the most voxels in
    the band is copied into a free pool slot with another color, and an
    active list with that slot after the last active row: every pixel the
    row hits gets a tie of bit-equal z_surf, which the copy (the larger
    flat index) must win."""
    state = _clone(state)
    sel = aidx.long()[has_surf]
    band = ((state.weight[sel].float() > 0)
            & (state.sdf[sel].float().abs() < CFG.voxel_size)).sum(dim=1)
    src = int(sel[torch.argmax(band)])
    free = int(torch.nonzero(state.block_key == geom.INVALID_KEY)[0])
    for f in ("block_key", "sdf", "weight", "surf"):
        getattr(state, f)[free] = getattr(state, f)[src]
    state.color[free] = 0x123456
    aidx = aidx.clone()
    aidx[int(n)] = free
    mask = torch.arange(aidx.shape[0], device=aidx.device) <= int(n)
    return state, aidx, state.surf[aidx.long()] & mask


@pytest.mark.cuda
@pytest.mark.parametrize("tie", [False, True])
def test_splat_zbuf_color_kernel_bit_equal(cuda, tie):
    """A color render (the color walk, then the resolve) bit-equal to its
    plain version, also where a forced tie decides the color: its
    z-buffer is kernel B's, its key buffer the plain walk's
    (``splat_keys_plain``); the plain versions are never called on the
    card by the wrappers, and kernel B is not launched."""
    state, _, _, pose, aidx, n = _scene_state(cuda)
    mask = torch.arange(aidx.shape[0], device=cuda) < n
    has_surf = state.surf[aidx.long()] & mask
    if tie:
        state, aidx, has_surf = _with_tie(state, aidx, n, has_surf)
    view = geom.invert_rigid(pose)
    counts = lambda: (splat_zbuf_color.launches, splat_zbuf.launches,  # noqa
                      splat_zbuf_plain.cuda_calls,
                      splat_color_plain.cuda_calls)
    before = counts()
    zk, ck = splat_zbuf_color(state, aidx, has_surf, view, CAM, CFG)
    torch.cuda.synchronize()
    assert counts() == (before[0] + 1, *before[1:])
    zp, cp = splat_zbuf_plain(state, aidx, has_surf, view, CAM, CFG,
                              with_color=True)
    assert torch.equal(zk.view(torch.int32), zp.view(torch.int32))
    assert torch.equal(ck, cp)
    assert torch.equal(zk.view(torch.int32), splat_zbuf(
        state, aidx, has_surf, view, CAM, CFG).view(torch.int32))
    args, keys, _, _ = sb.prepare_color(state, aidx, has_surf, view, CAM,
                                        CFG)
    sb.launch_color(args)
    assert torch.equal(keys, sb.splat_keys_plain(state, aidx, has_surf,
                                                 view, CAM, CFG))
    assert int((ck != 0).sum()) > 1000
    assert bool((ck == 0x123456).any()) == tie


def test_bytes_moved_hand_count():
    """The bound's byte counts at the phase-2/3 shapes (320x240, a
    32,768-row active list) against a hand count: 26,186 active rows read
    53,628,928 B of sdf and weight, 8,072 surface rows 16,531,456 B."""
    cam = CameraConfig()
    assert 26186 * 2048 == 53628928 and 8072 * 2048 == 16531456
    frame = 320 * 240 * (4 + 12)
    a = fa.bytes_moved(26186, 0, 32768, cam)
    assert a == 53628928 + frame + 26186 * 9 + 32768 * 8 + 68
    assert fa.bytes_moved(26186, 1000, 32768, cam) == a + 12000
    assert fa.bytes_moved(26186, 0, 32768, cam, with_color=False) \
        == a - 320 * 240 * 12
    b = sb.bytes_moved(8072, 32768, cam)
    assert b == 16531456 + 8072 * 8 + 32768 + 320 * 240 * 4 + 64
    # a color render: the colors written and one color read per covered
    # pixel; the 64-bit keys between its two kernels are not counted
    assert sb.color_bytes_moved(8072, 77000, 32768, cam) \
        == b + 320 * 240 * 4 + 4 * 77000


def test_operations_hand_count():
    """The bound's f32 operation counts: 46 per voxel of an active row and
    28 more per updated voxel for A; 3 per voxel of a surface row and 36
    more per voxel in the surface band for B. At the phase-2/3 state both
    stay below the time their bytes take at the card's rates."""
    assert fa.operations(1, 0) == 46 * 512
    assert fa.operations(26186, 1000) == 46 * 512 * 26186 + 28 * 1000
    # the bilinear variant: its 117-operation color sample in place of the
    # 15 of one color word, and 15 per pixel of the color-word image
    assert fa.operations(26186, 1000, bilinear=True, n_pixels=76800) \
        == fa.operations(26186, 1000) + 102 * 1000 + 15 * 76800
    assert fa.operations(26186, 1000, n_pixels=76800) \
        == fa.operations(26186, 1000)
    assert sb.operations(1, 0) == 3 * 512
    assert sb.operations(8072, 500) == 3 * 512 * 8072 + 36 * 500
    cam = CameraConfig()
    every = 26186 * 512
    assert fa.operations(26186, every) / 67e12 \
        < fa.bytes_moved(26186, every, 32768, cam) / 3.35e12
    assert sb.operations(8072, 8072 * 512) / 67e12 \
        < sb.bytes_moved(8072, 32768, cam) / 3.35e12


def _misaligned(state):
    """``state`` with its pool rows moved 2 bytes off a 16-byte boundary
    (contiguous views of a one-element-longer buffer)."""
    out = {}
    for f in ("sdf", "weight", "color"):
        t = getattr(state, f)
        buf = torch.zeros(t.numel() + 1, dtype=t.dtype, device=t.device)
        out[f] = buf[1:].view(t.shape)
        out[f].copy_(t)
    return state._replace(**out)


def test_wrappers_refuse_misaligned_pools():
    """The kernels copy rows with 16-byte bulk copies: a pool that is not
    16-byte aligned, or an ``n_active`` that is not int32, is refused by
    the wrappers' checks (run here on CPU tensors)."""
    state = blockmap.create(CFG, "cpu")
    bad = _misaligned(state)
    assert bad.sdf.is_contiguous() and bad.sdf.data_ptr() % 16 != 0
    aidx = torch.zeros(8, dtype=torch.int32)
    n = torch.zeros((), dtype=torch.int32)
    depth = torch.zeros(CAM.height, CAM.width)
    view = torch.eye(4)
    fa._check_inputs(state, depth, None, view, aidx, n, CAM)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa._check_inputs(bad, depth, None, view, aidx, n, CAM)
    with pytest.raises(ValueError, match="int32"):
        fa._check_inputs(state, depth, None, view, aidx, n.long(), CAM)
    # the color-word image's launch checks its own two tensors
    with pytest.raises(ValueError, match="color-word image"):
        fa.launch_color_words(torch.zeros(4, 4, 3),
                              torch.zeros(15, dtype=torch.int32))
    mask = torch.zeros(8, dtype=torch.bool)
    sb._check_inputs(state, aidx, mask, view)
    with pytest.raises(ValueError, match="16-byte aligned"):
        sb._check_inputs(bad, aidx, mask, view)


def test_color_render_refuses_flat_indices_past_32_bits():
    """The color walk packs flat indices (active-list position * 512 +
    voxel) into 32 bits: an active list of 2^23 rows fits, one more row is
    refused by the wrapper's checks (run here on CPU tensors)."""
    state = blockmap.create(CFG, "cpu")
    view = torch.eye(4)
    for m, ok in ((1 << 23, True), ((1 << 23) + 1, False)):
        aidx = torch.zeros(m, dtype=torch.int32)
        mask = torch.zeros(m, dtype=torch.bool)
        if ok:
            _, keys, _, _ = sb.prepare_color(state, aidx, mask, view, CAM,
                                             CFG)
            assert int(keys[0]) == sb.NO_HIT_KEY == 0x7F800000FFFFFFFF
        else:
            with pytest.raises(ValueError, match="32 bits"):
                sb.prepare_color(state, aidx, mask, view, CAM, CFG)


@settings(max_examples=60, deadline=None)
@given(st.data())
def test_key_min_is_nearest_then_largest_flat(data):
    """The color walk's rule: the min of ``pack_splat_keys`` over the
    voxels of a pixel (``scatter_reduce_`` amin, as the walk's atomics
    give) decodes to the least z_surf and, among voxels of bit-equal
    z_surf, the largest flat index; for positive finite z_surf, flat
    indices up to 2^32 - 1 and forced ties."""
    n = data.draw(st.integers(1, 40))
    pixels = data.draw(st.integers(1, 6))
    z_pool = data.draw(st.lists(
        st.floats(float(np.float32(1e-30)), float(np.float32(3e38)),
                  width=32), min_size=1, max_size=4))
    z = np.array(data.draw(st.lists(st.sampled_from(z_pool), min_size=n,
                                    max_size=n)), np.float32)
    flat = np.array(data.draw(st.lists(
        st.one_of(st.integers(0, 2 ** 32 - 1),
                  st.integers(2 ** 32 - 64, 2 ** 32 - 1)),
        min_size=n, max_size=n, unique=True)), np.int64)
    pix = np.array(data.draw(st.lists(st.integers(0, pixels - 1),
                                      min_size=n, max_size=n)), np.int64)
    keys = torch.full((pixels,), sb.NO_HIT_KEY, dtype=torch.int64)
    keys.scatter_reduce_(0, torch.from_numpy(pix), sb.pack_splat_keys(
        torch.from_numpy(z), torch.from_numpy(flat)), "amin",
        include_self=True)
    assert (keys >= 0).all()
    for q in range(pixels):
        at = pix == q
        if not at.any():
            assert int(keys[q]) == sb.NO_HIT_KEY
            continue
        zq = z[at].min()
        fq = flat[at][z[at].view(np.int32) == zq.view(np.int32)].max()
        k = int(keys[q])
        assert k >> 32 == int(zq.view(np.uint32))
        assert 0xFFFFFFFF - (k & 0xFFFFFFFF) == fq


def _full_list(state):
    idx, n = blockmap.compactify_all(state, CFG)
    return idx[:int(n)].contiguous(), n.to(torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("n_active", ["0", "1", "M"])
def test_kernels_bit_equal_at_list_edges(cuda, n_active):
    """Both kernels on an empty list, a one-row list and a full list
    (n_active == M, every allocated row): bit-equal to the plain versions,
    and rows past n_active get empty stats."""
    state, d, c, pose, aidx, n = _scene_state(cuda)
    if n_active == "M":
        aidx, n = _full_list(state)
        assert aidx.shape[0] == int(n) > 0
    else:
        n = torch.full((), int(n_active), dtype=torch.int32, device=cuda)
    sk, (mn_k, mx_k) = fused_integrate(_clone(state), d, c, pose, CAM, CFG,
                                       aidx, n)
    sp, (mn_p, mx_p) = _plain_integrate(_clone(state), d, c, pose, aidx, n)
    torch.cuda.synchronize()
    for f in ("sdf", "weight", "color", "surf"):
        assert torch.equal(_bits(getattr(sk, f)), _bits(getattr(sp, f))), f
    assert torch.equal(mn_k, mn_p) and torch.equal(mx_k, mx_p)
    assert torch.isinf(mn_k[int(n):]).all() and not mx_k[int(n):].any()
    mask = torch.arange(aidx.shape[0], device=cuda) < n
    has_surf = sk.surf[aidx.long()] & mask
    view = geom.invert_rigid(pose)
    zk = splat_zbuf(sk, aidx, has_surf, view, CAM, CFG)
    zp, cp = splat_zbuf_plain(sk, aidx, has_surf, view, CAM, CFG,
                              with_color=True)
    assert torch.equal(zk.view(torch.int32), zp.view(torch.int32))
    zc, ck = splat_zbuf_color(sk, aidx, has_surf, view, CAM, CFG)
    assert torch.equal(zc.view(torch.int32), zp.view(torch.int32))
    assert torch.equal(ck, cp)


@pytest.mark.cuda
@pytest.mark.parametrize("with_color", [True, False])
def test_fused_integrate_edge_value_frame(cuda, with_color):
    """Kernel A's in-kernel color word and depth tests on a frame with NaN,
    +-inf, negative, -0.0, > 1, exactly 1.0 and 254.5/255 colors, and NaN,
    0, exactly max_integration_distance and farther depth: bit-equal to
    the plain version (and the depth-only debug green without color)."""
    state, d, c, pose, aidx, n = _scene_state(cuda)
    d, c = d.clone(), c.clone()
    vals = (float("nan"), float("inf"), float("-inf"), -0.25, -0.0, 1.5,
            1.0, 254.5 / 255.0)
    for g, v in enumerate(vals):
        c[:, g::len(vals) + 1, g % 3] = v
    c[:, len(vals)::len(vals) + 1, :] = 1.0
    far = CFG.max_integration_distance
    for k, v in enumerate((float("nan"), 0.0, far, far + 0.25)):
        d[k::16, :] = v
    c = c if with_color else None
    sk, (mn_k, mx_k) = fused_integrate(_clone(state), d, c, pose, CAM, CFG,
                                       aidx, n)
    sp, (mn_p, mx_p) = _plain_integrate(_clone(state), d, c, pose, aidx, n)
    torch.cuda.synchronize()
    for f in ("sdf", "weight", "color", "surf"):
        assert torch.equal(_bits(getattr(sk, f)), _bits(getattr(sp, f))), f
    assert torch.equal(mn_k, mn_p) and torch.equal(mx_k, mx_p)
    assert bool((sk.weight != state.weight).any())


@pytest.mark.cuda
def test_kernels_launch_on_the_current_stream(cuda):
    """``launch`` issues each kernel on the stream that is current when it
    is called, so a CUDA graph captures it: a replay of the captured
    launches gives the plain versions' bits."""
    state, d, c, pose, aidx, n = _scene_state(cuda)
    view = geom.invert_rigid(pose)
    sk = _clone(state)
    args_a, stats = fa.prepare(sk, d, c, view, CAM, CFG, aidx, n)
    mask = torch.arange(aidx.shape[0], device=cuda) < n
    has_surf = state.surf[aidx.long()] & mask
    args_b, zbuf = sb.prepare(state, aidx, has_surf, view, CAM, CFG)
    # a launch of each first, so that no module is loaded during capture
    fused_integrate(_clone(state), d, c, pose, CAM, CFG, aidx, n)
    splat_zbuf(state, aidx, has_surf, view, CAM, CFG)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        fa.launch(args_a)
        sb.launch(args_b)
    graph.replay()
    sp, (mn_p, mx_p) = _plain_integrate(_clone(state), d, c, pose, aidx, n)
    zp, _ = splat_zbuf_plain(state, aidx, has_surf, view, CAM, CFG)
    torch.cuda.synchronize()
    for f in ("sdf", "weight", "color", "surf"):
        assert torch.equal(_bits(getattr(sk, f)), _bits(getattr(sp, f))), f
    assert torch.equal(stats[:, 0], mn_p) and torch.equal(stats[:, 1], mx_p)
    assert torch.equal(zbuf, zp.view(torch.int32))


@pytest.mark.cuda
def test_wrappers_refuse_misaligned_pools_on_the_card(cuda):
    state, d, c, pose, aidx, n = _scene_state(cuda)
    bad = _misaligned(state)
    before = (fused_integrate.launches, splat_zbuf.launches)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fused_integrate(bad, d, c, pose, CAM, CFG, aidx, n)
    mask = torch.arange(aidx.shape[0], device=cuda) < n
    with pytest.raises(ValueError, match="16-byte aligned"):
        splat_zbuf(bad, aidx, mask, geom.invert_rigid(pose), CAM, CFG)
    assert (fused_integrate.launches, splat_zbuf.launches) == before


@pytest.mark.cuda
@pytest.mark.parametrize("frame", ["scene", "edge_values", "depth_only"])
def test_fused_integrate_bilinear_bit_equal(cuda, frame):
    """Kernel A's bilinear variant (``MapConfig(bilinear_color=True)``)
    against the plain version's ``_bilinear_color``: rows, surface flags
    and stats bit-equal on the scene's frame, on a frame of edge color
    values (invalid corners drop out) and depth-only (debug green); its
    color-word image equals ``integrate.frame_color_word`` (none is made
    for a depth-only frame); the launches are counted as the variant's and
    the image's, and the plain version is not called on the card."""
    cfg = dataclasses.replace(CFG, bilinear_color=True)
    state, d, c, pose, aidx, n = _scene_state(cuda)
    if frame == "edge_values":
        c = c.clone()
        for g, v in enumerate((float("nan"), float("inf"), -0.25, 1.5)):
            c[:, g::5, g % 3] = v
    elif frame == "depth_only":
        c = None
    counts = lambda: (fused_integrate.launches,  # noqa: E731
                      fused_integrate.bilinear_launches,
                      fused_integrate.color_word_launches,
                      integ.integrate.cuda_calls)
    before = counts()
    sk, (mn_k, mx_k) = fused_integrate(_clone(state), d, c, pose, CAM, cfg,
                                       aidx, n)
    assert counts() == (before[0], before[1] + 1,
                        before[2] + (c is not None), before[3])
    if c is not None:
        # the color-word image the variant reads: integrate.frame_color_word
        words = torch.empty(CAM.height * CAM.width, dtype=torch.int32,
                            device=cuda)
        fa.launch_color_words(c.contiguous(), words)
        assert torch.equal(words, integ.frame_color_word(c, CAM, cuda))
    mask = torch.arange(aidx.shape[0], device=cuda) < n
    sp, (mn_p, mx_p) = integ.integrate(_clone(state), d, c, pose, CAM, cfg,
                                       active_idx=aidx, active_mask=mask)
    torch.cuda.synchronize()
    for f in ("sdf", "weight", "color", "surf"):
        assert torch.equal(_bits(getattr(sk, f)), _bits(getattr(sp, f))), f
    assert torch.equal(mn_k, mn_p) and torch.equal(mx_k, mx_p)
    assert bool((sk.weight != state.weight).any())
    if frame == "scene":
        near, _ = fused_integrate(_clone(state), d, c, pose, CAM, CFG, aidx,
                                  n)
        assert bool((near.color != sk.color).any())


@pytest.mark.cuda
def test_solve6_kernel_matches_plain_and_f64(cuda):
    """The kernel against its plain version on the seeded bank (within
    ``solve6.disagreements``), cond within 1e-4 of an f64 SVD's, and a
    non-finite system degenerate with x = 0."""
    from voxelhashing_tpu_torch.ops import solve6 as s6
    thres = 2.0e4
    a, b, _ = s6.system_bank(seed=7, n_per_kind=48, cond_thres=thres)
    ta, tb = torch.from_numpy(a).to(cuda), torch.from_numpy(b).to(cuda)
    launches = s6.solve6.launches
    got = tuple(t.cpu().numpy() for t in s6.solve6(ta, tb, thres))
    assert s6.solve6.launches == launches + 1
    ref = tuple(t.cpu().numpy() for t in s6.solve6_plain(ta, tb, thres))
    s64 = np.linalg.svd(a.astype(np.float64), compute_uv=False)
    c64 = s64[:, 0] / np.maximum(s64[:, -1], 1e-20)
    assert not s6.disagreements(ref, got, c64, thres)
    ok = ~got[2]
    np.testing.assert_allclose(got[1][ok], c64[ok], rtol=1e-4)
    bad = ta[0].clone()
    bad[1, 2] = float("nan")
    x, cond, degen = s6.solve6(bad, tb[0], thres)
    assert bool(degen) and not bool(torch.any(x != 0))


@pytest.mark.cuda
def test_icp_update_kernel_matches_plain(cuda):
    """The update kernel against its plain version on the seeded bank of
    updates (every flag path), within ``icp_update.disagreements``; one
    launch an update."""
    from voxelhashing_tpu_torch.ops import icp_update as iu
    for e in iu.update_bank(seed=11, n_per_case=6):
        state, system, mean, inv_std, planar, color = iu.bank_inputs(e,
                                                                     cuda)
        before = iu.clone_state(state)
        ref = iu.clone_state(state)
        launches = iu.icp_update.launches
        iu.icp_update(state, system, mean, inv_std, planar, iu.BANK_GATE, 1,
                      2, e["begin"], color)
        assert iu.icp_update.launches == launches + 1
        iu.icp_update_plain(ref, system, mean, inv_std, planar,
                            iu.BANK_GATE, 1, 2, e["begin"], color)
        torch.cuda.synchronize()
        bad = iu.disagreements(before, ref, state, mean, inv_std,
                               iu.BANK_GATE, 1, 2)
        assert not bad, (e["case"], bad)


def _step_config():
    from voxelhashing_tpu_torch.config import EngineConfig
    return EngineConfig(camera=CAM, map=dataclasses.replace(
        CFG, gc_enabled=True, gc_starve_interval=3), offline=False)


@pytest.mark.cuda
def test_make_step_graphs_are_the_eager_step(cuda):
    """Eight frames through ``make_step`` on the card (host inputs, staged
    behind the view graph on every graphed frame) against eight eager
    steps (starve frames 3 and 6 among them): the final state and every
    frame's diagnostics bit-equal (read after the last call: copies), the
    same kernel launches, and two host syncs in a tracked frame after the
    graphs are captured."""
    import warnings
    from voxelhashing_tpu_torch import engine
    from voxelhashing_tpu_torch.ops import icp_update as iu, solve6 as s6
    cfg = _step_config()
    poses = make_trajectory(8)
    frames = [render_depth(p, CAM, Scene(), noise_sigma=0.002, seed=i,
                           device=cuda) for i, p in enumerate(poses)]
    counters = ((fused_integrate, "launches"), (sb.splat_zbuf, "launches"),
                (iu.icp_update, "launches"), (s6.solve6, "launches"))

    def counts():
        return [getattr(o, a) for o, a in counters]

    a = engine.create(cfg, initial_pose=poses[0], device=cuda)
    b = engine.create(cfg, initial_pose=poses[0], device=cuda)
    step = engine.make_step(cfg)
    host = [(d.cpu(), c.cpu()) for d, c in frames]
    c0 = counts()
    eager_diags, graphed_diags = [], []
    for d, c in frames:
        a, da = engine.step(a, d, c, cfg)
        eager_diags.append(da)
    eager = [n - m for n, m in zip(counts(), c0)]
    c0 = counts()
    for i, (d, c) in enumerate(host):
        if i == 7:
            torch.cuda.synchronize()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    b, db = step(b, d, c)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            syncs = [w for w in caught
                     if "synchronizing CUDA operation" in str(w.message)]
            assert len(syncs) == 2, [str(w.message) for w in syncs]
        else:
            b, db = step(b, d, c)
        graphed_diags.append(db)
    graphed = [n - m for n, m in zip(counts(), c0)]
    assert graphed == eager and eager[0] == 8 and eager[2] > 0 \
        and eager[3] == 0
    for x, y in zip(list(a.map) + [a.pose, a.frame, a.n_integrated],
                    list(b.map) + [b.pose, b.frame, b.n_integrated]):
        assert torch.equal(_bits(x), _bits(y))
    for i, (da, db) in enumerate(zip(eager_diags, graphed_diags)):
        for x, y in zip(da, db):
            assert torch.equal(torch.nan_to_num(x), torch.nan_to_num(y)), i
    assert set(step.graphs) == {"view", "front", "back", "back_starve"}
    assert step.inputs_behind == 7
    assert step.pool_bytes_adopted == 0
    step.close()


def _hold_icp_pass(delta, lv, scatter, sigma):
    """One iteration through the pass kernels and their plain versions
    (``icp_linearize.check_pass``) at the edge bank's thresholds."""
    from voxelhashing_tpu_torch.ops import icp_linearize as il
    th = il.EDGE_THRES
    bad, _ = il.check_pass(delta, lv, (th["dist_thres"], th["normal_thres"],
                                       th["depth_min"], th["depth_max"],
                                       scatter),
                           th["planar_thres"], sigma)
    assert not bad, bad


@pytest.mark.cuda
def test_icp_pass_kernels_match_plain_on_the_edge_bank(cuda):
    """The pass kernels against their plain versions on
    ``icp_linearize.edge_bank`` (NaN pixels, pz == 0, projections off
    every border, counts of 0, a 1x1 level, a row shard, strided maps),
    depth-only with the scatter and with the photometric rows, the fused
    launch against the split pair bit for bit (``check_pass``); two runs
    of each form give the same bits."""
    from voxelhashing_tpu_torch.ops import icp_linearize as il
    th = il.EDGE_THRES
    args = (th["dist_thres"], th["normal_thres"], th["depth_min"],
            th["depth_max"], True)
    for e in il.edge_bank():
        lv = il.edge_level(e, cuda)
        delta = torch.from_numpy(e["delta"]).to(cuda)
        _hold_icp_pass(delta, lv, True, None)
        _hold_icp_pass(delta, lv, False, th["color_sigma"])
        for fused in (False, True):
            runs = []
            for _ in range(2):
                if fused:
                    a, lin = il.associate_linearize(
                        delta, lv, *args, th["planar_thres"],
                        th["color_sigma"])
                else:
                    a = il.associate(delta, lv, *args)
                    lin = il.linearize(delta, lv, a, a.moments, a.s,
                                       th["planar_thres"], th["color_sigma"])
                runs.append([t.clone() for t in a.moments + (a.s,)
                             + lin.depth + lin.color
                             + (lin.mean, lin.inv_std, lin.planar)])
            for x, y in zip(*runs):
                assert torch.equal(x, y)


def _plane_level(device, h, w, seed):
    """A seeded h x w level (``icp_linearize._edge_maps``: a tilted noisy
    plane, its normals and a texture) against a second one, with a small
    seeded motion."""
    from voxelhashing_tpu_torch.ops import icp_linearize as il
    rng = np.random.default_rng(seed)
    cam = CameraConfig(width=w, height=h, fx=w * 0.9, fy=w * 0.9,
                       cx=(w - 1) / 2.0, cy=(h - 1) / 2.0)
    md = il._edge_maps(rng, h, w, cam)
    inp = il._edge_maps(rng, h, w, cam)
    delta = np.eye(4, dtype=np.float32)
    delta[:3, 3] = rng.normal(0.0, 0.003, 3)

    def t(a):
        return torch.from_numpy(a).to(device)

    lv = il.Level(t(inp[0]), t(inp[1]), t(md[0]), t(md[1]), cam, t(inp[2]),
                  t(md[2]))
    return lv, t(delta)


@pytest.mark.cuda
@pytest.mark.parametrize("color", [False, True])
def test_icp_pass_sums_follow_the_numpy_model(cuda, color):
    """The kernels' sums are ``icp_sum_order.summed_in_kernel_order``'s, at
    a 320x240 level (threads with two pixels on 132 SMs) and on the edge
    bank: the association's sums and the depth system bit for bit (the
    model sums the plain versions' f32 terms, which the kernels form bit
    for bit), the photometric system within ``disagreements`` (its
    transform is cuBLAS's on the plain side)."""
    from voxelhashing_tpu_torch.ops import icp_linearize as il
    th = il.EDGE_THRES
    sigma = th["color_sigma"] if color else None
    levels = [_plane_level(cuda, 240, 320, 7)] + [
        (il.edge_level(e, cuda), torch.from_numpy(e["delta"]).to(cuda))
        for e in il.edge_bank()]
    for lv, delta in levels:
        scatter = not color
        a, lin = il.associate_linearize(
            delta, lv, th["dist_thres"], th["normal_thres"], th["depth_min"],
            th["depth_max"], scatter, th["planar_thres"], sigma)
        moments, s, depth, col = icp_sum_order.model_sums(
            delta, lv, a, lin.mean, lin.inv_std, scatter, sigma, lv.grid)
        got = a.moments + ((a.s,) if scatter else ()) + lin.depth
        want = moments + ((s,) if scatter else ()) + depth
        for g, m in zip(got, want):
            assert il.same_bits(g.cpu(), m.reshape(g.shape).to(g.dtype)), \
                (lv.n, lv.grid, g, m)
        if color:
            _, sc_c = il.scale_linearize(delta, lv, a, lin, sigma)
            assert il.disagreements(lin.color, col, sc_c, lv.n) == []


@pytest.mark.cuda
@pytest.mark.parametrize("color", [False, True])
def test_icp_fused_pass_survives_graph_replays(cuda, color):
    """A CUDA graph holding the fused launch (cooperative, with its
    generation word and counters in the level's buffers), replayed twice,
    gives the eager launch's outputs bit for bit, and so does an eager
    launch after the replays."""
    from voxelhashing_tpu_torch.ops import icp_linearize as il
    th = il.EDGE_THRES
    lv, delta = _plane_level(cuda, 240, 320, 8)
    args = (delta, lv, th["dist_thres"], th["normal_thres"],
            th["depth_min"], th["depth_max"], not color, th["planar_thres"],
            th["color_sigma"] if color else None)
    eager = il.pass_outputs(*il.associate_linearize(*args))
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        il.associate_linearize(*args)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    before = (il.associate_linearize.launches,
              il.associate_linearize.color_launches)
    with torch.cuda.graph(graph):
        out = il.associate_linearize(*args)
    assert (il.associate_linearize.launches,
            il.associate_linearize.color_launches) == (
        before[0] + (not color), before[1] + color)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        replayed = il.pass_outputs(*out)
        assert [k for k, _ in replayed] == [k for k, _ in eager]
        for (k, x), (_, y) in zip(replayed, eager):
            assert il.same_bits(x, y), k
    after = il.pass_outputs(*il.associate_linearize(*args))
    for (k, x), (_, y) in zip(after, eager):
        assert il.same_bits(x, y), k


@pytest.mark.cuda
@pytest.mark.parametrize("color", [False, True])
def test_icp_fused_pass_refuses_aliased_rows(cuda, color):
    """The fused launch's linearization rows are written while slower CTAs
    still read the association's, so a launch whose two partial-row
    regions overlap is refused (and counts no launch); the level's own
    regions are disjoint and launch."""
    from voxelhashing_tpu_torch.ops import icp_linearize as il
    th = il.EDGE_THRES
    lv, delta = _plane_level(cuda, 240, 320, 9)
    args, _ = il.prepare_associate_linearize(
        delta, lv, th["dist_thres"], th["normal_thres"], th["depth_min"],
        th["depth_max"], not color, th["planar_thres"],
        th["color_sigma"] if color else None)
    a, lin = args[0], args[1]
    rows = lv.grid * il.ASSOC_SUMS * 8
    assert lin.partials >= a.partials + rows or \
        a.partials >= lin.partials + lv.grid * 2 * il.SYS_SUMS * 8
    own = lin.partials
    before = (il.associate_linearize.launches,
              il.associate_linearize.color_launches)
    for alias in (a.partials, a.partials + rows - 8):
        lin.partials = alias
        with pytest.raises(RuntimeError, match="CUDA error"):
            il.launch(args)
    assert (il.associate_linearize.launches,
            il.associate_linearize.color_launches) == before
    lin.partials = own
    il.launch(args)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("rgbd", [False, True])
def test_track_runs_the_pass_kernels(cuda, rgbd):
    """``tracking.track`` on the card: one fused pass launch an outer
    iteration and none of the split pair on a single device (with the
    photometric rows under RGB-D), the split pair under ``reduce_fn``
    with the same pose bits, no plain pass on the card, each iteration
    held to the plain versions, and the pose within 1e-4 of the CPU's."""
    from voxelhashing_tpu_torch import tracking
    from voxelhashing_tpu_torch.config import FilterConfig, TrackerConfig
    from voxelhashing_tpu_torch.ops import icp_linearize as il
    from voxelhashing_tpu_torch.ops.image import preprocess
    poses = make_trajectory(3, translation_step=0.01)
    maps = []
    for i in (0, 2):
        d, c = render_depth(poses[i], CAM, Scene(), noise_sigma=0.002,
                            seed=i, device=cuda)
        f = preprocess(d, c, CAM, FilterConfig())
        maps.append((f.points, f.normals, f.intensity))
    cfg = TrackerConfig(levels=2, max_outer_iter=(6, 4),
                        max_inner_iter=(1, 1))
    kw = (dict(input_intensity=maps[1][2], model_intensity=maps[0][2])
          if rgbd else {})

    def counts():
        return (il.associate.launches, il.linearize.launches,
                il.linearize.color_launches, il.associate_linearize.launches,
                il.associate_linearize.color_launches,
                il.associate_plain.cuda_calls, il.linearize_plain.cuda_calls,
                il.color_system_plain.cuda_calls)

    inputs = (maps[1][0], maps[1][1], maps[0][0], maps[0][1],
              torch.eye(4, device=cuda), CAM, cfg)
    before = counts()
    res = tracking.track(*inputs, **kw)
    after = counts()
    assert [a - b for a, b in zip(after, before)] == \
        [0, 0, 0, 0 if rgbd else 10, 10 if rgbd else 0, 0, 0, 0]
    before = counts()
    split = tracking.track(*inputs, **kw, reduce_fn=lambda sums: sums)
    after = counts()
    assert [a - b for a, b in zip(after, before)] == \
        [10, 0 if rgbd else 10, 10 if rgbd else 0, 0, 0, 0, 0, 0]
    for x, y in zip(res, split):
        assert il.same_bits(x, y)
    cpu = tracking.track(*(t.cpu() for t in (maps[1][0], maps[1][1],
                                             maps[0][0], maps[0][1])),
                         torch.eye(4), CAM, cfg,
                         **{k: v.cpu() for k, v in kw.items()})
    assert bool(res.valid) and bool(cpu.valid)
    np.testing.assert_allclose(res.pose.cpu().numpy(), cpu.pose.numpy(),
                               atol=1e-4, rtol=0)
    lv = il.Level(maps[1][0], maps[1][1], maps[0][0], maps[0][1], CAM,
                  *((maps[1][2], maps[0][2]) if rgbd else ()))
    _hold_icp_pass(res.pose.contiguous(), lv, not rgbd,
                   0.1 if rgbd else None)


@pytest.mark.cuda
def test_preprocess_kernel_bit_equal_on_the_edge_bank(cuda):
    """``preprocess_kernel`` against ``preprocess_plain`` on every
    ``preprocess.edge_bank`` frame (NaN, +-inf, 0, negative and
    out-of-range depths, an all-invalid frame, an odd frame smaller than a
    tile, the filter off, no color, a 17x17 window): depth, points,
    normals and intensity bit for bit, one launch each."""
    from voxelhashing_tpu_torch.ops import preprocess as pp
    for e in pp.edge_bank():
        d, c = pp.edge_frame(e, cuda)
        n0 = pp.preprocess_depth.launches
        got = pp.preprocess_depth(d, c, e["cam"], e["flt"])
        ref = pp.preprocess_plain(d, c, e["cam"], e["flt"])
        assert pp.preprocess_depth.launches == n0 + 1
        for name in ("depth", "points", "normals", "intensity"):
            a, b = getattr(got, name), getattr(ref, name)
            assert (a is None) == (b is None), (e["case"], name)
            if a is not None:
                assert torch.equal(a.view(torch.int32),
                                   b.view(torch.int32)), (e["case"], name)


@pytest.mark.cuda
def test_alloc_candidates_kernel_matches_plain_on_the_edge_bank(cuda):
    """``alloc_candidates_kernel`` against ``alloc_candidates_plain`` on
    every ``alloc_candidates.edge_bank`` frame, in pixel and tile mode, at
    each phase as a host int and as a device int32 scalar, with novelty
    off and on: the keys position for position, one launch each."""
    from voxelhashing_tpu_torch.ops import alloc_candidates as ac
    for e in ac.edge_bank():
        d = torch.from_numpy(e["depth"]).to(cuda)
        pose = torch.from_numpy(e["pose"]).to(cuda)
        md = torch.from_numpy(e["model_depth"]).to(cuda)
        for tile in (1, e["tile"]):
            for phase in e["phases"]:
                phases = [phase] if phase is None else [
                    phase, torch.tensor(phase, dtype=torch.int32,
                                        device=cuda)]
                for ph in phases:
                    for model in (None, md):
                        kw = dict(tile=tile, phase=ph, model_depth=model)
                        n0 = ac.alloc_candidates.launches
                        got = ac.alloc_candidates(d, pose, e["cam"],
                                                  e["cfg"], **kw)
                        ref = ac.alloc_candidates_plain(d, pose, e["cam"],
                                                        e["cfg"], **kw)
                        assert ac.alloc_candidates.launches == n0 + 1
                        assert torch.equal(got, ref), (e["case"], tile, ph)


@pytest.mark.cuda
def test_step_launches_the_front_kernels(cuda):
    """``engine.step`` on the card: one preprocess launch and one
    candidates launch a frame, and no plain version on the card."""
    from voxelhashing_tpu_torch import engine
    from voxelhashing_tpu_torch.config import EngineConfig
    from voxelhashing_tpu_torch.ops import alloc_candidates as ac
    from voxelhashing_tpu_torch.ops import preprocess as pp
    cfg = EngineConfig(camera=CAM, map=CFG, offline=False)
    poses = make_trajectory(3)
    state = engine.create(cfg, device=cuda)
    counts = (pp.preprocess_depth.launches, ac.alloc_candidates.launches,
              pp.preprocess_plain.cuda_calls,
              ac.alloc_candidates_plain.cuda_calls)
    for i in range(3):
        d, c = render_depth(poses[i], CAM, Scene(), noise_sigma=0.002,
                            seed=i, device=cuda)
        state, _ = engine.step(state, d, c, cfg)
    after = (pp.preprocess_depth.launches, ac.alloc_candidates.launches,
             pp.preprocess_plain.cuda_calls,
             ac.alloc_candidates_plain.cuda_calls)
    assert [a - b for a, b in zip(after, counts)] == [3, 3, 0, 0]


def _map_fields_equal(a, b):
    """The map fields of ``a`` and ``b`` that differ (pool rows by bits)."""
    return [f for f in blockmap.MapState._fields
            if not torch.equal(_bits(getattr(a, f)), _bits(getattr(b, f)))]


@pytest.mark.cuda
def test_hash_kernels_bit_equal_on_the_edge_bank(cuda):
    """``hash_alloc_kernel`` and ``hash_delete_kernel`` against
    ``blockmap.allocate_plain`` and ``delete_blocks_plain`` on every
    ``hash_table.edge_bank`` call, from one state on the card: every field
    of the map (the pool rows too) and the count bit for bit, one insert
    launch a round, one delete launch a call; an empty key list raises.
    "over_caps" stages live keys over eight chunks."""
    from voxelhashing_tpu_torch.ops import hash_table as ht
    for e in ht.edge_bank():
        kind, cfg, a, b = e["op"]
        if e["case"] == "over_caps":
            st = ht.edge_state(e, "cpu")
            _, staged, chunks = ht.stage_counts(st.table_key,
                                                torch.from_numpy(a), cfg)
            assert chunks == -(-staged // ht.ALLOC_THREADS) == 8
        st = ht.edge_state(e, cuda)
        keys = torch.from_numpy(a).to(cuda)
        if a.size == 0:
            with pytest.raises(ValueError, match="no candidate keys"):
                blockmap.allocate(st, keys, cfg, rounds=b)
            continue
        n0 = (ht.allocate.launches, ht.delete_blocks.launches)
        if kind == "allocate":
            got, n = blockmap.allocate(_clone(st), keys, cfg, rounds=b)
            ref, n_ref = blockmap.allocate_plain(_clone(st), keys, cfg,
                                                 rounds=b)
            assert int(n) == int(n_ref), e["case"]
            want = (n0[0] + b, n0[1])
        else:
            mask = torch.from_numpy(b).to(cuda)
            got = blockmap.delete_blocks(_clone(st), keys, mask, cfg)
            ref = blockmap.delete_blocks_plain(_clone(st), keys, mask, cfg)
            want = (n0[0], n0[1] + 1)
        torch.cuda.synchronize()
        assert (ht.allocate.launches, ht.delete_blocks.launches) == want
        assert not _map_fields_equal(got, ref), (e["case"],
                                                 _map_fields_equal(got, ref))


@pytest.mark.cuda
def test_gc_kernel_bit_equal_on_the_gc_bank(cuda):
    """``hash_delete_kernel<true>`` (GC's free pass, one launch) against
    ``integrate.garbage_collect_plain`` on every ``hash_table.gc_bank``
    call, with the stats as two tensors and as kernel A's strided
    columns, and on a starve frame's re-read stats, from one state on the
    card: every field of the map and the whole pools bit for bit; its
    status words and ticket back at 0 after each launch."""
    from voxelhashing_tpu_torch.ops import hash_table as ht
    for e in ht.gc_bank():
        st, idx, mask, ms, mw = ht.gc_inputs(e, cuda)
        n0 = (ht.garbage_collect.launches, ht.delete_blocks.launches)
        got = integ.garbage_collect(_clone(st), idx, mask, e["cfg"],
                                    cached_stats=(ms, mw))
        ref = integ.garbage_collect_plain(_clone(st), idx, mask, e["cfg"],
                                          cached_stats=(ms, mw))
        torch.cuda.synchronize()
        assert (ht.garbage_collect.launches,
                ht.delete_blocks.launches) == (n0[0] + 1, n0[1]), e["case"]
        assert not _map_fields_equal(got, ref), (e["case"],
                                                 _map_fields_equal(got, ref))
        res = ht.reserve(cuda, e["cfg"])
        assert not res.status.any() and not res.ticket.any(), e["case"]
        # the stats as kernel A gives them: the columns of one [M, 2]
        pair = torch.stack([ms, mw], 1)
        got = integ.garbage_collect(_clone(st), idx, mask, e["cfg"],
                                    cached_stats=(pair[:, 0], pair[:, 1]))
        assert not _map_fields_equal(got, ref), e["case"]
        if e["case"] == "gc_over_cap":   # the stats re-read from the rows
            got = integ.garbage_collect(_clone(st), idx, mask, e["cfg"])
            ref = integ.garbage_collect_plain(_clone(st), idx, mask,
                                              e["cfg"])
            assert not _map_fields_equal(got, ref)


@pytest.mark.cuda
def test_ray_bounds_kernel_one_launch_and_its_accumulators(cuda):
    """``ray_bounds_kernel`` bit-equal to ``ray_bounds_plain`` on the edge
    bank's bounded cases and on a grid past the shared-memory path (1-pixel
    tiles: 12,288 tiles), one launch a call with no fill, the persistent
    accumulators back at their identity after each launch."""
    from voxelhashing_tpu_torch.ops import raymarch as rm
    from voxelhashing_tpu_torch.config import RaycastConfig
    cases = [(e, rm.edge_inputs(e, cuda)) for e in rm.edge_bank()
             if e["active"] is not None]
    state, _, _, pose, aidx, n = _scene_state(cuda)
    mask = torch.arange(aidx.shape[0], device=cuda) < n
    for tile in (16, 1):
        cases.append(({"case": f"scene, tile {tile}", "cam": CAM,
                       "cfg": CFG, "rc": RaycastConfig(mode="march",
                                                       splat_tile=tile)},
                      (state, pose, aidx, mask)))
    for e, (st, pose, aidx, mask) in cases:
        view = geom.invert_rigid(pose)
        n0 = rm.ray_bounds.launches
        got = rm.ray_bounds(st.block_key, aidx, mask, view, e["cam"],
                            e["cfg"], e["rc"])
        ref = rm.ray_bounds_plain(st.block_key, aidx, mask, view, e["cam"],
                                  e["cfg"], e["rc"])
        torch.cuda.synchronize()
        assert rm.ray_bounds.launches == n0 + 1
        for a, b in zip(got, ref):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32)), \
                e["case"]
        ty, tx = rm.tiles(e["cam"], e["rc"])
        acc = rm.reserve(cuda, ty * tx)
        assert bool((acc == rm.IDENTITY).all()), e["case"]
    assert max(ty * tx for ty, tx in [rm.tiles(CAM, RaycastConfig(
        mode="march", splat_tile=1))]) > 6144


@pytest.mark.cuda
def test_step_and_make_step_launch_the_hash_kernels(cuda):
    """``engine.step`` and ``engine.make_step`` on the card: one insert and
    one GC launch (``hash_delete_kernel<true>``) an integrated frame (GC
    on), no list delete, the same counts through the graphs, and no plain
    version on the card."""
    from voxelhashing_tpu_torch import engine
    from voxelhashing_tpu_torch.ops import hash_table as ht
    cfg = _step_config()
    poses = make_trajectory(6)
    frames = [render_depth(p, CAM, Scene(), noise_sigma=0.002, seed=i,
                           device=cuda) for i, p in enumerate(poses)]

    def counts():
        return (ht.allocate.launches, ht.garbage_collect.launches,
                ht.delete_blocks.launches,
                blockmap.allocate_plain.cuda_calls,
                blockmap.delete_blocks_plain.cuda_calls,
                integ.garbage_collect_plain.cuda_calls)

    for run in ("eager", "graphed"):
        state = engine.create(cfg, initial_pose=poses[0], device=cuda)
        step = engine.make_step(cfg) if run == "graphed" else None
        c0 = counts()
        for d, c in frames:
            state, _ = (step(state, d, c) if step is not None
                        else engine.step(state, d, c, cfg))
        torch.cuda.synchronize()
        assert [x - y for x, y in zip(counts(), c0)] == [6, 6, 0, 0, 0,
                                                         0], run
        if step is not None:
            step.close()


def _raymarch_pair(state, pose, cam, cfg, rc, aidx, mask):
    """The bounds and the march by the kernels and by their plain versions
    on the same inputs: ((bounds, hits) kernel, (bounds, hits) plain)."""
    from voxelhashing_tpu_torch.ops import raymarch as rm
    out = []
    for bounds_fn, march_fn in ((rm.ray_bounds, rm.march),
                                (rm.ray_bounds_plain, rm.march_plain)):
        bounds = None
        if aidx is not None:
            bounds = bounds_fn(state.block_key, aidx, mask,
                               geom.invert_rigid(pose), cam, cfg, rc)
        out.append((bounds, march_fn(state, pose, cam, cfg, rc, bounds)))
    torch.cuda.synchronize()
    return out


def _hits_differ(a, b):
    """The fields of two ``MarchHits`` that differ in their bits."""
    bad = []
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        if x is None and y is None:
            continue
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        if not torch.equal(x, y):
            bad.append(f)
    return bad


@pytest.mark.cuda
@pytest.mark.parametrize("use_gradients", [False, True])
def test_raymarch_kernels_bit_equal_on_the_edge_bank(cuda, use_gradients):
    """``ray_bounds_kernel`` and ``raymarch_kernel`` against their plain
    versions on every ``raymarch.edge_bank`` case: the tile bounds and
    every field of the hits bit for bit (NaN where no hit), one launch of
    each a call."""
    from voxelhashing_tpu_torch.ops import raymarch as rm
    for e in rm.edge_bank():
        st, pose, aidx, mask = rm.edge_inputs(e, cuda)
        rc = dataclasses.replace(e["rc"], use_gradients=use_gradients)
        n0 = (rm.ray_bounds.launches, rm.march.launches)
        (bk, hk), (bp, hp) = _raymarch_pair(st, pose, e["cam"], e["cfg"], rc,
                                            aidx, mask)
        with_bounds = aidx is not None
        assert (rm.ray_bounds.launches - n0[0],
                rm.march.launches - n0[1]) == (int(with_bounds), 1)
        if with_bounds:
            for a, b in zip(bk, bp):
                assert torch.equal(a.view(torch.int32), b.view(torch.int32)), \
                    e["case"]
        assert not _hits_differ(hk, hp), (e["case"], _hits_differ(hk, hp))


@pytest.mark.cuda
@pytest.mark.parametrize("use_gradients", [False, True])
def test_raymarch_kernels_bit_equal_on_a_fused_map(cuda, use_gradients):
    """Both kernels on a map after two fusions, from the next frame's pose
    with its active list, at the JAX defaults (48 samples, 16-pixel
    tiles): bit-equal to the plain versions, and the rendered frame
    through the shared epilogue too."""
    from voxelhashing_tpu_torch import raycast
    from voxelhashing_tpu_torch.config import RaycastConfig
    state, _, _, pose, aidx, n = _scene_state(cuda)
    mask = torch.arange(aidx.shape[0], device=cuda) < n
    rc = RaycastConfig(mode="march", use_gradients=use_gradients)
    (bk, hk), (bp, hp) = _raymarch_pair(state, pose, CAM, CFG, rc, aidx,
                                        mask)
    for a, b in zip(bk, bp):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert not _hits_differ(hk, hp), _hits_differ(hk, hp)
    assert int(hk.found.sum()) > CAM.width * CAM.height // 4
    ok = raycast.march_epilogue(hk, pose, CAM)
    ref = raycast.march_epilogue(hp, pose, CAM)
    for f in ("depth", "points", "normals", "color"):
        assert torch.equal(getattr(ok, f).view(torch.int32),
                           getattr(ref, f).view(torch.int32)), f


@pytest.mark.cuda
def test_march_and_insert_kernels_replay_in_a_graph(cuda):
    """The march (with gradients, on a fused map from the next pose) and a
    round of the insert (on the "over_caps" edge call; the graph restores
    the table clones before it) captured in one CUDA graph and replayed
    twice: each replay bit-equal to the eager launches, one launch of each
    counted at the capture."""
    from voxelhashing_tpu_torch.config import RaycastConfig
    from voxelhashing_tpu_torch.ops import hash_table as ht
    from voxelhashing_tpu_torch.ops import raymarch as rm
    state, _, _, pose, aidx, n = _scene_state(cuda)
    mask = torch.arange(aidx.shape[0], device=cuda) < n
    rc = RaycastConfig(mode="march", use_gradients=True)
    bounds = rm.ray_bounds(state.block_key, aidx, mask,
                           geom.invert_rigid(pose), CAM, CFG, rc)
    m_args, hits = rm.prepare_march(state, pose, CAM, CFG, rc, bounds)
    e = next(x for x in ht.edge_bank() if x["case"] == "over_caps")
    _, hcfg, keys, _ = e["op"]
    st = ht.edge_state(e, cuda)
    a_args, outs = ht.prepare_allocate(
        st.table_key, st.table_val, st.block_key, st.free_stack, st.n_free,
        st.dense_upto, torch.from_numpy(keys).to(cuda), hcfg, rounds=1)

    def run():
        for dst, src in zip(outs[:3], (st.table_key, st.table_val,
                                        st.block_key)):
            dst.copy_(src)
        rm.launch(m_args)
        ht.launch_allocate(a_args[0])

    run()
    torch.cuda.synchronize()
    eager = [t.clone() for t in hits if t is not None] + \
        [t.clone() for t in outs]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = (rm.march.launches, ht.allocate.launches)
    with torch.cuda.graph(graph):
        run()
    assert (rm.march.launches, ht.allocate.launches) == (before[0] + 1,
                                                         before[1] + 1)
    for t in list(hits) + list(outs):
        if t is not None:
            t.zero_()
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        got = [t for t in hits if t is not None] + list(outs)
        assert all(torch.equal(_int_bits(x), _int_bits(y))
                   for x, y in zip(got, eager))
    assert int(outs[5]) > 0


@pytest.mark.cuda
def test_march_step_launches_the_raymarch_kernels(cuda):
    """``engine.step`` and ``engine.make_step`` with the march renderer on
    the card: one bounds and one march launch a frame, the same counts
    through the graphs, and no plain version on the card."""
    from voxelhashing_tpu_torch import engine
    from voxelhashing_tpu_torch.config import RaycastConfig
    from voxelhashing_tpu_torch.ops import raymarch as rm
    cfg = dataclasses.replace(_step_config(),
                              raycast=RaycastConfig(mode="march"))
    poses = make_trajectory(6)
    frames = [render_depth(p, CAM, Scene(), noise_sigma=0.002, seed=i,
                           device=cuda) for i, p in enumerate(poses)]

    def counts():
        return (rm.ray_bounds.launches, rm.march.launches,
                rm.ray_bounds_plain.cuda_calls, rm.march_plain.cuda_calls)

    for run in ("eager", "graphed"):
        state = engine.create(cfg, initial_pose=poses[0], device=cuda)
        step = engine.make_step(cfg) if run == "graphed" else None
        c0 = counts()
        for d, c in frames:
            state, _ = (step(state, d, c) if step is not None
                        else engine.step(state, d, c, cfg))
        torch.cuda.synchronize()
        got = [x - y for x, y in zip(counts(), c0)]
        assert got == [6, 6, 0, 0], (run, got)
        if step is not None:
            step.close()


@pytest.mark.cuda
def test_preprocess_reciprocal_division_on_every_float(cuda):
    """The preprocess kernel's division by c = 2 sigma_r^2 (each tap's x
    clamped into ``division_clamp``, then through y = RN(1/c):
    ``range_weight``) against the IEEE division on the card, over every
    f32 x in [0, +inf] at the default sigma_r and the edge bank's: no x
    whose weight differs, no quotient that differs on its range, and
    expf(-x) is 1 for every x <= 2^-26 and 0 for every x >= 128."""
    from voxelhashing_tpu_torch.ops import preprocess as pp
    from voxelhashing_tpu_torch.config import FilterConfig
    lib = _build.library("preprocess")
    for sigma_r in (0.1, 0.05, 1.0):
        flt = FilterConfig(depth_sigma_r=sigma_r)
        c = np.float32(pp.two_sr2(flt))
        out = torch.zeros(4, dtype=torch.int64, device=cuda)
        _build.check(lib.vh_preprocess_check_division(
            float(c), float(np.float32(1.0) / c), *pp.division_clamp(flt),
            _build.ptr(out), _build.stream_ptr(cuda)), "preprocess")
        assert out.cpu().tolist() == [0, 0, 0, 0], sigma_r
