"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card: K1 and K2 (ops/nonlocal_attn.py) and the
rasterizer of the device geometry maps (geometry/triangulation.py).

Every test here needs an NVIDIA GPU (marker `cuda`) and skips without one.
This file imports torch and the port only, so it runs on a machine without
JAX:  python -m pytest --noconftest tests/test_torch_kernels_cuda.py
"""

import os

import numpy as np
import pytest
import torch

from blindshadowremoval_tpu_torch.data.dataset import _geometry_primitives
from blindshadowremoval_tpu_torch.geometry import triangulation
from blindshadowremoval_tpu_torch.geometry.landmarks import LM_REF
from blindshadowremoval_tpu_torch.ops.nonlocal_attn import (
    KERNEL_TOLERANCE,
    _launch_fwd,
    bwd_tolerance,
    nonlocal_attention,
    nonlocal_attention_bwd,
    nonlocal_attention_bwd_reference,
    nonlocal_attention_reference,
)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernel runs only there")
    return torch.device("cuda")


# the f32 kernels (3xTF32 on the tensor cores) at B=1 and 80, N=64 (one
# key tile of K1 at D=128, one key block of K2), 65, 200 and 1024, D=128
# and 256
F32_CASES = [(1, 64, 128), (80, 64, 256), (1, 65, 256), (80, 65, 128),
             (1, 200, 128), (80, 200, 256), (1, 1024, 256), (80, 1024, 128),
             (80, 1024, 256)]

# K1's cases: the main path's widths, ragged tails of the 128- and 64-key
# tiles, a single row (N=1), one row past a tile (N=129), 300 batch
# elements of one partial query tile each (N=64), and the batches of the
# TSM and RGB paths
FWD_CASES = [
    (2, 1024, 128, torch.bfloat16),    # TSM: an anchor and its mirror
    (16, 1024, 128, torch.bfloat16),   # TSM: a fused UCB pass of 8 pairs
    (10, 1024, 256, torch.bfloat16),   # RGB: one evaluation sample
    (80, 1024, 256, torch.bfloat16),   # RGB: a fused UCB pass
    (2, 200, 128, torch.bfloat16),
    (2, 1024, 256, torch.bfloat16),
    (2, 1024, 128, torch.float32),
    (2, 77, 256, torch.float32),
    (2, 1, 128, torch.bfloat16),
    (2, 129, 128, torch.bfloat16),
    (2, 1000, 256, torch.bfloat16),
    (300, 64, 128, torch.bfloat16),
] + [(b, n, d, torch.float32) for b, n, d in F32_CASES]


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,d,dtype", FWD_CASES)
def test_kernel_matches_plain_on_card(cuda_device, b, n, d, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    t, p, g = (0.3 * torch.randn(b, n, d, generator=gen, device=cuda_device)
               for _ in range(3))
    t, p, g = t.to(dtype), p.to(dtype), g.to(dtype)
    before = nonlocal_attention.launches
    with torch.no_grad():
        out = nonlocal_attention(t, p, g)
        torch.cuda.synchronize()
        ref = nonlocal_attention_reference(t, p, g)
    assert nonlocal_attention.launches == before + 1
    # KERNEL_TOLERANCE says why these limits (ops/nonlocal_attn.py)
    atol, rtol = KERNEL_TOLERANCE[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)


@pytest.mark.cuda
def test_kernel_keeps_batch_elements_apart(cuda_device):
    # batch element 1 is 50 randn, its neighbours 0.3 randn: keys of one
    # element leaking into another's softmax (an unmasked ragged tile read
    # past row N), or rows stored past N, would move the whole output far
    # outside the tolerance
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    t, p, g = (0.3 * torch.randn(3, 200, 128, generator=gen,
                                 device=cuda_device) for _ in range(3))
    for x in (t, p, g):
        x[1] = 50 * torch.randn(200, 128, generator=gen, device=cuda_device)
    t, p, g = t.bfloat16(), p.bfloat16(), g.bfloat16()
    with torch.no_grad():
        out = nonlocal_attention(t, p, g)
        torch.cuda.synchronize()
        ref = nonlocal_attention_reference(t, p, g)
    atol, rtol = KERNEL_TOLERANCE[torch.bfloat16]
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)
    # K2 on K1's outputs: elements 0 and 2 must not see element 1 either
    # (element 1's scores of ~1e5 lie outside KERNEL_BWD_TOLERANCE's
    # derivation, so it is left out of the comparison)
    do = torch.randn(3, 200, 128, generator=gen, device=cuda_device).bfloat16()
    out, lse = _launch_fwd(t, p, g, with_lse=True)
    grads = nonlocal_attention_bwd(t, p, g, out, lse, do)
    torch.cuda.synchronize()
    keep = [0, 2]
    ref = nonlocal_attention_bwd_reference(t[keep], p[keep], g[keep], do[keep])
    for name, a, r in zip(("dtheta", "dphi", "dg"), grads, ref):
        atol, rtol = bwd_tolerance(r, torch.bfloat16)
        torch.testing.assert_close(a[keep].float(), r.float(), atol=atol,
                                   rtol=rtol, msg=name)


@pytest.mark.cuda
def test_kernel_rejects_misaligned_view(cuda_device):
    # contiguous, but one element past a 16-byte boundary: the kernel's
    # vector loads would fault, so the wrapper refuses it before launching
    flat = torch.zeros(2 * 64 * 128 + 1, dtype=torch.bfloat16,
                       device=cuda_device)
    t = flat[1:].view(2, 64, 128)
    assert t.is_contiguous()
    before = nonlocal_attention.launches
    with pytest.raises(ValueError, match="aligned"):
        nonlocal_attention(t, t, t)
    assert nonlocal_attention.launches == before


def _operands(device, b, n, d, dtype, seed=0):
    """theta, phi, g of 0.3 randn and dout of randn: the scales
    KERNEL_BWD_TOLERANCE was derived at."""
    gen = torch.Generator(device=device).manual_seed(seed)
    t, p, g = (0.3 * torch.randn(b, n, d, generator=gen, device=device)
               for _ in range(3))
    do = torch.randn(b, n, d, generator=gen, device=device)
    return [x.to(dtype) for x in (t, p, g, do)]


# K2 through the autograd Function, so fed K1's own output and row
# logsumexp: the main path's widths, ragged tails, N around the 64-query
# tile and the 128-key block of the bf16 kernel at D=128, and 300 batch
# elements of one partial tile each (N=64)
@pytest.mark.cuda
@pytest.mark.parametrize("b,n,d,dtype", [
    (64, 1024, 128, torch.bfloat16),   # the train step's shape
    (64, 1024, 256, torch.bfloat16),   # the RGB train step's shape
    (2, 200, 128, torch.bfloat16),     # ragged N
    (2, 1024, 256, torch.bfloat16),    # RGB's width
    (2, 1024, 128, torch.float32),
    (2, 77, 256, torch.float32),
    (2, 1, 128, torch.bfloat16),       # one row
    (2, 65, 128, torch.bfloat16),      # one query past a 64-query tile
    (2, 127, 128, torch.bfloat16),     # one key short of a 128-key block
    (2, 129, 128, torch.bfloat16),     # one key past a 128-key block
    (2, 1000, 256, torch.bfloat16),    # ragged 64-key tiles
    (300, 64, 128, torch.bfloat16),    # short N, the largest gradients
] + [(b, n, d, torch.float32) for b, n, d in F32_CASES])
def test_bwd_kernel_matches_plain_on_card(cuda_device, b, n, d, dtype):
    t, p, g, do = _operands(cuda_device, b, n, d, dtype)
    leaves = [x.clone().requires_grad_() for x in (t, p, g)]
    k1, k2 = nonlocal_attention.launches, nonlocal_attention_bwd.launches
    out = nonlocal_attention(*leaves)
    grads = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    assert nonlocal_attention.launches == k1 + 1
    assert nonlocal_attention_bwd.launches == k2 + 1
    ref = nonlocal_attention_bwd_reference(t, p, g, do)
    # KERNEL_BWD_TOLERANCE says why these limits (ops/nonlocal_attn.py)
    for name, a, r in zip(("dtheta", "dphi", "dg"), grads, ref):
        assert a.dtype == dtype
        atol, rtol = bwd_tolerance(r, dtype)
        torch.testing.assert_close(a.float(), r.float(), atol=atol, rtol=rtol,
                                   msg=name)


@pytest.mark.cuda
def test_bwd_kernel_keeps_batch_elements_apart(cuda_device):
    # K2 alone, fed the plain forward's output and logsumexp: batch element
    # 1 is 50 times its neighbours, so a query tile or key block that read
    # past row N into the next element, or a gradient stored or added past
    # row N, would move elements 0 and 2 far outside the tolerance
    t, p, g, do = _operands(cuda_device, 3, 200, 128, torch.float32)
    for x in (t, p, g, do):
        x[1] *= 50
    t, p, g, do = (x.bfloat16() for x in (t, p, g, do))
    out = nonlocal_attention_reference(t, p, g)
    lse = torch.logsumexp(torch.matmul(t.float(), p.float().transpose(1, 2)),
                          dim=-1).contiguous()
    grads = nonlocal_attention_bwd(t, p, g, out, lse, do)
    torch.cuda.synchronize()
    keep = [0, 2]
    ref = nonlocal_attention_bwd_reference(t[keep], p[keep], g[keep], do[keep])
    for name, a, r in zip(("dtheta", "dphi", "dg"), grads, ref):
        assert bool(torch.isfinite(a).all()), name
        atol, rtol = bwd_tolerance(r, torch.bfloat16)
        torch.testing.assert_close(a[keep].float(), r.float(), atol=atol,
                                   rtol=rtol, msg=name)


@pytest.mark.cuda
def test_bwd_kernel_runs_agree(cuda_device):
    # dtheta's f32 partial sums arrive from the key blocks in no fixed
    # order, so two runs may differ in rounding; by no more than the
    # tolerance, and dphi and dg not at all
    t, p, g, do = _operands(cuda_device, 16, 1024, 128, torch.bfloat16)
    out, lse = _launch_fwd(t, p, g, with_lse=True)
    first = nonlocal_attention_bwd(t, p, g, out, lse, do)
    second = nonlocal_attention_bwd(t, p, g, out, lse, do)
    torch.cuda.synchronize()
    atol, rtol = bwd_tolerance(first[0], torch.bfloat16)
    torch.testing.assert_close(second[0].float(), first[0].float(), atol=atol,
                               rtol=rtol)
    for a, b in zip(first[1:], second[1:]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.cuda
def test_forward_saves_the_row_logsumexp(cuda_device):
    t, p, g, _ = _operands(cuda_device, 2, 200, 128, torch.bfloat16)
    out, lse = _launch_fwd(t, p, g, with_lse=True)
    ref = torch.logsumexp(torch.matmul(t.float(), p.float().transpose(1, 2)),
                          dim=-1)
    # f32 max + log(sum of fast exps): a few ulps of values near 5
    torch.testing.assert_close(lse, ref, atol=1e-4, rtol=1e-5)
    plain, none = _launch_fwd(t, p, g, with_lse=False)
    assert none is None
    torch.testing.assert_close(out, plain, rtol=0, atol=0)


@pytest.mark.cuda
def test_bwd_kernel_rejects_misaligned_view(cuda_device):
    flat = torch.zeros(2 * 64 * 128 + 1, dtype=torch.bfloat16,
                       device=cuda_device)
    t = flat[1:].view(2, 64, 128)
    lse = torch.zeros(2, 64, device=cuda_device)
    before = nonlocal_attention_bwd.launches
    with pytest.raises(ValueError, match="aligned"):
        nonlocal_attention_bwd(t, t, t, t, lse, t)
    with pytest.raises(TypeError, match="all alike"):
        x = torch.zeros(2, 64, 128, dtype=torch.bfloat16, device=cuda_device)
        nonlocal_attention_bwd(x, x, x, x, lse, x.float())
    assert nonlocal_attention_bwd.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,d", [(16, 1024, 128), (3, 200, 256),
                                   (8, 64, 128)])
def test_f32_kernels_repeat_bitwise(cuda_device, b, n, d):
    # the f32 kernels sum in a fixed order (no atomics; K2's dtheta adds
    # its key blocks' partial sums in block order): the same inputs give
    # the same bits, forward, logsumexp and all three gradients
    t, p, g, do = _operands(cuda_device, b, n, d, torch.float32)
    first = _launch_fwd(t, p, g, with_lse=True)
    second = _launch_fwd(t, p, g, with_lse=True)
    grads = [nonlocal_attention_bwd(t, p, g, *first, do) for _ in range(2)]
    torch.cuda.synchronize()
    for a, c in zip(first + grads[0], second + grads[1]):
        assert torch.equal(a, c)


@pytest.mark.cuda
def test_f32_kernels_ignore_tf32_switches(cuda_device):
    # 3xTF32 is the kernels' own arithmetic: PyTorch's TF32 switches,
    # which steer cuBLAS and cuDNN, change none of their bits
    t, p, g, do = _operands(cuda_device, 4, 200, 128, torch.float32)
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    runs = []
    try:
        for allow in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = allow
            torch.backends.cudnn.allow_tf32 = allow
            out, lse = _launch_fwd(t, p, g, with_lse=True)
            runs.append((out, lse, *nonlocal_attention_bwd(t, p, g, out, lse,
                                                           do)))
        torch.cuda.synchronize()
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
    for a, c in zip(*runs):
        assert torch.equal(a, c)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [128, 256])
def test_f32_kernels_keep_batch_elements_apart(cuda_device, d):
    # as the bf16 tests above, in f32: batch element 1 is 50 times its
    # neighbours, so a tile read past row N into the next element, or a
    # row stored past it, would move elements 0 and 2 out of tolerance
    # (element 1's scores of ~1e5 lie outside the tolerances' derivation)
    t, p, g, do = _operands(cuda_device, 3, 200, d, torch.float32)
    for x in (t, p, g, do):
        x[1] *= 50
    keep = [0, 2]
    out, lse = _launch_fwd(t, p, g, with_lse=True)
    grads = nonlocal_attention_bwd(t, p, g, out, lse, do)
    torch.cuda.synchronize()
    atol, rtol = KERNEL_TOLERANCE[torch.float32]
    torch.testing.assert_close(
        out[keep], nonlocal_attention_reference(t[keep], p[keep], g[keep]),
        atol=atol, rtol=rtol)
    ref = nonlocal_attention_bwd_reference(t[keep], p[keep], g[keep],
                                           do[keep])
    for name, a, r in zip(("dtheta", "dphi", "dg"), grads, ref):
        assert bool(torch.isfinite(a).all()), name
        atol, rtol = bwd_tolerance(r, torch.float32)
        torch.testing.assert_close(a[keep], r, atol=atol, rtol=rtol,
                                   msg=name)


# ---------------------------------------------------------------- rasterizer

GEOMETRY_KEYS = ("lm", "face_pts", "uv_tris", "face_tris", "reg_tris")
GOLDEN_LM = np.load(os.path.join(os.path.dirname(__file__), "goldens",
                                 "goldens.npz"))["lm"]


def _landmark_sets(n, seed=0):
    """n landmark sets: the goldens' landmarks, then LM_REF jittered by
    0.005-0.02 (a face's worth of pose and shape)."""
    rng = np.random.default_rng(seed)
    sets = [GOLDEN_LM.astype(np.float32)]
    while len(sets) < n:
        scale = rng.uniform(0.005, 0.02)
        sets.append((LM_REF + rng.normal(scale=scale, size=LM_REF.shape)
                     ).astype(np.float32))
    return sets[:n]


def _stack(views, device):
    return [torch.from_numpy(np.stack([v[k] for v in views])).to(device)
            for k in GEOMETRY_KEYS]


def _plain_maps(geo, size):
    """The plain path on the card, with cuDNN's TF32 off for the face
    map's blur (the kernel's blur is f32)."""
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        return triangulation.geometry_maps_plain(*geo, size)
    finally:
        torch.backends.cudnn.allow_tf32 = saved


def _assert_maps_match(kernel, plain):
    """uv and reg bit for bit, the blurred face within 1e-6.  The latter
    also makes the face's coverage equal: at the first pixel (row-major)
    where two coverages differ, the blurred maps differ two rows up and two
    columns left (clamped) by at least the smallest tap squared, ~0.005."""
    for key in ("uv", "reg"):
        assert kernel[key].shape == plain[key].shape, key
        diff = (kernel[key] != plain[key]).nonzero()
        assert len(diff) == 0, (key, len(diff), diff[:5].tolist())
    assert kernel["face"].shape == plain["face"].shape
    err = (kernel["face"] - plain["face"]).abs().max().item()
    assert err <= 1e-6, err


@pytest.mark.cuda
@pytest.mark.parametrize("size", [64, 256])
@pytest.mark.parametrize("b", [1, 10, 64, 128])
def test_geometry_kernel_matches_plain_on_card(cuda_device, b, size):
    views = [_geometry_primitives(lm) for lm in _landmark_sets(b, seed=b)]
    geo = _stack(views, cuda_device)
    before = dict(triangulation.RASTER_CALLS)
    kernel = triangulation.device_geometry_maps(*geo, size)
    torch.cuda.synchronize()
    assert triangulation.RASTER_CALLS == {
        "kernel": before["kernel"] + 1, "plain": before["plain"]}
    _assert_maps_match(kernel, _plain_maps(geo, size))


def _edge_case_views(size):
    """Four views: (0) a sliver and a zero-area triangle (den guarded to
    1e-12), put first in every topology, whose points sit on one pixel
    column: the sliver holds the column between its ends, the zero-area
    triangle the rest of it, far outside its bounding box; (1) every
    topology all padding; (2) landmarks snapped
    to the pixel grid, so edges shared by two triangles and the hull's
    boundary run through pixel centres; (3) LM_REF as it is."""
    lin = triangulation._grid(size, torch.device("cpu")).numpy()
    col = size // 2
    lm = _landmark_sets(2, seed=7)[1]
    lm[0] = (lin[col], 0.2)
    lm[16] = (lin[col], 0.8)
    lm[8] = (lin[col] + 1e-6, 0.5)
    odd = _geometry_primitives(lm)
    for key in ("uv_tris", "face_tris", "reg_tris"):
        odd[key] = np.concatenate(
            [[[0, 16, 8], [0, 0, 16]], odd[key][:-2]]).astype(np.int32)
    empty = _geometry_primitives(LM_REF.astype(np.float32))
    for key in ("uv_tris", "face_tris", "reg_tris"):
        empty[key] = np.full_like(empty[key], -1)
    snapped = (np.round(_landmark_sets(3, seed=8)[2] * (size - 1))
               / (size - 1)).astype(np.float32)
    return [odd, empty, _geometry_primitives(snapped),
            _geometry_primitives(LM_REF.astype(np.float32))], col


@pytest.mark.cuda
@pytest.mark.parametrize("size", [64, 256])
def test_geometry_kernel_edge_cases(cuda_device, size):
    views, col = _edge_case_views(size)
    geo = _stack(views, cuda_device)
    kernel = triangulation.geometry_maps_kernel(*geo, size)
    torch.cuda.synchronize()
    plain = _plain_maps(geo, size)
    # the cases do what they are for: the zero-area triangle holds pixels
    # of its column above and below its bounding box, and the view of all
    # padding has no hit outside reg_in (the static canonical topology)
    assert bool(plain["uv"][0, 0, col].ne(0).any())
    assert bool(plain["uv"][0, size - 1, col].ne(0).any())
    assert not bool(plain["uv"][1].ne(0).any())
    assert not bool(plain["reg"][1, ..., 3:].ne(0).any())
    assert not bool(plain["face"][1].ne(0).any())
    _assert_maps_match(kernel, plain)


@pytest.mark.cuda
def test_geometry_kernel_keeps_views_apart(cuda_device):
    # each view of a batch of 10 distinct faces, rasterized alone, gives
    # the same bits as in the batch
    size = 256
    views = [_geometry_primitives(lm) for lm in _landmark_sets(10, seed=3)]
    batch = triangulation.geometry_maps_kernel(
        *_stack(views, cuda_device), size)
    for i in (0, 4, 9):
        alone = triangulation.geometry_maps_kernel(
            *_stack(views[i:i + 1], cuda_device), size)
        for key in ("uv", "reg", "face"):
            assert torch.equal(batch[key][i:i + 1], alone[key]), (i, key)


@pytest.mark.cuda
def test_geometry_kernel_is_one_launch(cuda_device):
    # one kernel a call, counted where it launches, and no host-to-device
    # copy: the constants are uploaded once per device, the staged int32
    # topologies taken as they are
    views = [_geometry_primitives(lm) for lm in _landmark_sets(10)]
    geo = _stack(views, cuda_device)
    before = dict(triangulation.RASTER_CALLS)
    triangulation.device_geometry_maps(*geo, 256)
    triangulation.geometry_maps_kernel(*geo, 256)
    torch.cuda.synchronize()
    assert triangulation.RASTER_CALLS == {
        "kernel": before["kernel"] + 2, "plain": before["plain"]}
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        triangulation.device_geometry_maps(*geo, 256)
        torch.cuda.synchronize()
    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    names = [e.name for e in device]
    assert [n for n in names if "geometry_maps" in n] and len(names) == 1, \
        names


@pytest.mark.cuda
def test_geometry_kernel_on_a_second_device():
    if torch.cuda.device_count() < 2:
        pytest.skip("needs a second CUDA device")
    dev = torch.device("cuda", 1)
    views = [_geometry_primitives(lm) for lm in _landmark_sets(4)]
    geo = _stack(views, dev)
    with torch.cuda.device(0):      # the current device is another card
        kernel = triangulation.device_geometry_maps(*geo, 64)
    torch.cuda.synchronize(dev)
    assert kernel["uv"].device == dev
    with torch.cuda.device(dev):
        _assert_maps_match(kernel, _plain_maps(geo, 64))


@pytest.mark.cuda
def test_service_forward_takes_the_kernel(cuda_device):
    from blindshadowremoval_tpu_torch.config import get_config
    from blindshadowremoval_tpu_torch.eval.serving import (
        ShadowRemovalService,
    )

    cfg = get_config("in_the_wild", img_size=64, n_res=2,
                     compute_dtype="float32")
    svc = ShadowRemovalService(cfg, None, batch_size=2, device=cuda_device)
    rng = np.random.default_rng(0)
    image = rng.uniform(size=(220, 200, 3)).astype(np.float32)
    lm = (LM_REF * 130 + 35).astype(np.float32)
    before = dict(triangulation.RASTER_CALLS)
    out = svc.remove_shadows([image], [lm])
    assert triangulation.RASTER_CALLS == {
        "kernel": before["kernel"] + 1, "plain": before["plain"]}
    assert np.isfinite(out[0]["pred"]).all()
