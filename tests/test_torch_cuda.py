"""The port's CUDA kernels against their plain versions, on the card.

Skips without a GPU. On a machine with one (and without JAX), run
    python -m pytest --noconftest tests/test_torch_cuda.py -q
Integer outputs and kept counts must match exactly; tolerances as in
chip_smoke.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

from fovsplat_torch import convert
from fovsplat_torch.data import proxy
from fovsplat_torch.eval import mmfr
from fovsplat_torch.models import state as S
from fovsplat_torch.ops import blend, foveated as fov
from fovsplat_torch.ops import foveation, projection, sh, stats
from fovsplat_torch.ops import rasterize as rast
from fovsplat_torch.ops.kernels import blend_fov as bf
from fovsplat_torch.ops import binning
from fovsplat_torch.ops.kernels import blend_fwd as bfw
from fovsplat_torch.ops.kernels import blend_stats as bs
from fovsplat_torch.ops.kernels import build_table as bt
from fovsplat_torch.ops.kernels import compact_table as ct
from fovsplat_torch.ops.kernels import expand_fov as ef
from fovsplat_torch.ops.kernels import expand_ps1 as ep1
from fovsplat_torch.ops.kernels import hvs_loss as hvs
from fovsplat_torch.ops.kernels import project_sh as psh
from fovsplat_torch.ops.kernels import segment_reduce as sr
from fovsplat_torch.ops.kernels import ssim as ssim_k
from fovsplat_torch.ops.rasterize import RasterizeConfig
from fovsplat_torch.perception import metameric
from fovsplat_torch.train import loops

pytestmark = pytest.mark.cuda
W, H, N = 320, 224, 20_000


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _scene(dev, gaze):
    sc = proxy.bicycle_proxy(n=N, seed=2)
    model = convert.fov_model_from_numpy(
        sc["means"], sc["scales"], sc["rotations"], sc["opacities4"],
        sc["shs_dcs"], sc["shs_rest"], sc["highest_levels"], device=dev)
    cam = proxy.proxy_camera(W, H, device=dev)
    levels = foveation.compute_tile_levels(
        torch.tensor(gaze, dtype=torch.float32, device=dev), W, H, 0.05)
    bbox = fov.level_bboxes(levels, (W + 15) // 16, (H + 15) // 16, 4)
    return model, cam, levels, bbox


@pytest.mark.parametrize("gaze", [(0.5, 0.5), (0.2, 0.8)])
def test_kernels_match_plain(cuda, gaze):
    model, cam, levels, bbox = _scene(cuda, gaze)
    gx, T = (W + 15) // 16, ((W + 15) // 16) * ((H + 15) // 16)
    tk, ck, totk = bt.build_table(model, cam, bbox)
    tp, cp, totp = bt.build_table_plain(model, cam, bbox)
    assert torch.equal(ck, cp) and torch.equal(totk, totp)
    for r in (bt.ROW_RX0, bt.ROW_RY0, bt.ROW_RW, bt.ROW_TNUM, bt.ROW_HL,
              bt.ROW_VALID):
        assert torch.equal(tk[r], tp[r]), r
    torch.testing.assert_close(tk, tp, rtol=1e-5, atol=1e-5)

    args = (tk, ck, levels, 4, gx, 1 << 20, 1 << 20)
    ek, ep = ef.expand_fov(*args), ef.expand_fov_plain(*args)
    k = int(ek.kept)
    assert k == int(ep.kept) and k > 1000
    for name in ("tile", "gid", "depth"):
        assert torch.equal(getattr(ek, name)[:k], getattr(ep, name)[:k])
    assert torch.equal(ek.attrs[:, :k], ep.attrs[:, :k])

    key, dbits = fov.fused_key32(ek.tile, ek.depth, ek.kept[0], T)
    pairs, seg = fov.sort_pairs(key, dbits, ek.attrs, T, True)
    gxl, gyl, _, tb = foveation.compute_tile_level_infos(levels, W, H)
    _, l1, l2 = fov.chain_masks(levels, gxl, gyl, tb)
    for a, b in zip(bf.blend_fov(pairs, seg, l1, l2, gx),
                    bf.blend_fov_plain(pairs, seg, l1, l2, gx)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4)


def _expand_exact(args):
    """Kernel 2 and its plain version on `args`: kept, and the first
    min(kept, cap_out) lanes of every output, bit for bit."""
    ek, ep = ef.expand_fov(*args), ef.expand_fov_plain(*args)
    kept = int(ek.kept)
    assert kept == int(ep.kept)
    k = min(kept, args[-1])
    for name in ("tile", "gid", "depth", "attrs"):
        assert torch.equal(getattr(ek, name)[..., :k],
                           getattr(ep, name)[..., :k]), name
    return ek


@pytest.mark.parametrize("cut", ["pair_capacity", "cap_out"])
def test_expand_capacity_cuts_match_plain(cuda, cut):
    """Kernel 2 with a pair capacity that cuts a Gaussian's rect in the
    middle, and with a kept-pair capacity below the kept count."""
    model, cam, levels, bbox = _scene(cuda, (0.5, 0.5))
    gx = (W + 15) // 16
    tk, ck, totk = bt.build_table(model, cam, bbox)
    full = _expand_exact((tk, ck, levels, 4, gx, 1 << 20, 1 << 20))
    kept = int(full.kept)
    if cut == "pair_capacity":
        c, tnum = ck.long(), tk[bt.ROW_TNUM].long()
        g = int(((c >= int(totk) // 2) & (tnum > 2)).nonzero()[0])
        cap = int(c[g]) + int(tnum[g]) // 2
        ek = _expand_exact((tk, ck, levels, 4, gx, cap, 1 << 20))
        assert 0 < int(ek.kept) < kept
        assert int(ek.gid[:int(ek.kept)].max()) <= g
    else:
        cap_out = kept // 2 + 3
        ek = _expand_exact((tk, ck, levels, 4, gx, 1 << 20, cap_out))
        assert int(ek.kept) == kept
        assert torch.equal(ek.tile[:cap_out], full.tile[:cap_out])


def _reduce_stream(kind, chunk, n, dev):
    """Sorted gid streams at the edges of kernel 7's chunks: one run over
    several chunks, all sentinel, no sentinel, runs that end exactly at a
    chunk edge."""
    rng = np.random.default_rng(5)
    cap = 6 * chunk + 37
    if kind == "long_run":
        body = [np.sort(rng.integers(0, 77, chunk // 2)),
                np.full(3 * chunk + 5, 77),
                np.sort(rng.integers(78, n, chunk))]
    elif kind == "all_sentinel":
        body = []
    elif kind == "no_sentinel":
        body = [np.sort(rng.integers(0, n, cap))]
    else:
        body = [np.full(chunk, 3), np.full(chunk - 10, 5), np.full(10, 6),
                np.full(chunk + 1, 8), np.full(chunk - 1, 9)]
    gid = np.concatenate(body + [np.full(cap, n)])[:cap].astype(np.int32)
    vals = rng.normal(0, 1, (9, cap)).astype(np.float32)
    vals[:, gid == n] = 0.0
    return torch.from_numpy(gid).to(dev), torch.from_numpy(vals).to(dev)


@pytest.mark.parametrize("kind", ["long_run", "all_sentinel", "no_sentinel",
                                  "chunk_edge"])
def test_reduce_edge_streams_match_plain(cuda, kind):
    """Kernel 7 against its plain version on the edge streams (within 1e-5
    of the largest sum), every column written (the output buffer is
    recycled from one full of NaN), two launches bit-identical."""
    from fovsplat_torch.ops.kernels import _build
    chunk = _build.load("segment_reduce").fs_segment_reduce_chunk()
    n = 5000
    gid, vals = _reduce_stream(kind, chunk, n, cuda)
    junk = torch.full((9, n), float("nan"), device=cuda)
    del junk
    rk = sr.reduce_by_sorted_gid(gid, vals, n)
    rp = sr.reduce_by_sorted_gid_plain(gid, vals, n)
    assert bool(torch.isfinite(rk).all())
    if kind == "all_sentinel":
        assert not bool(rk.any())
    else:
        torch.testing.assert_close(rk, rp, rtol=1e-5,
                                   atol=1e-5 * float(rp.abs().max()))
    assert torch.equal(rk, sr.reduce_by_sorted_gid(gid, vals, n))


def test_frame_matches_cpu_and_counts_launches(cuda):
    sc = proxy.bicycle_proxy(n=N, seed=2)
    cfg = RasterizeConfig(pair_capacity=1 << 20, sort_exact_depth=True)
    outs = []
    for d in (cuda, torch.device("cpu")):
        m = convert.fov_model_from_numpy(
            sc["means"], sc["scales"], sc["rotations"], sc["opacities4"],
            sc["shs_dcs"], sc["shs_rest"], sc["highest_levels"], device=d)
        before = [k.launches for k in (bt.build_table, ef.expand_fov,
                                       bf.blend_fov)]
        o = fov.rasterize_fov_soa(m, proxy.proxy_camera(W, H, device=d),
                                  torch.tensor([0.4, 0.6], device=d), 0.05,
                                  config=cfg)
        after = [k.launches for k in (bt.build_table, ef.expand_fov,
                                      bf.blend_fov)]
        outs.append((o, [a - b for a, b in zip(after, before)]))
    (oc, lc), (oh, lh) = outs
    assert lc == [1, 1, 1] and lh == [0, 0, 0]
    assert int(oc["num_pairs"]) == int(oh["num_pairs"])
    torch.testing.assert_close(oc["render"].cpu(), oh["render"], rtol=0,
                               atol=1e-4)


def test_wrappers_reject_bad_inputs(cuda):
    model, cam, levels, bbox = _scene(cuda, (0.5, 0.5))
    with pytest.raises(ValueError, match="bbox"):
        bt.build_table(model, cam, bbox.long())
    tk, ck, _ = bt.build_table(model, cam, bbox)
    with pytest.raises(ValueError, match="cum"):
        ef.expand_fov(tk, ck.long(), levels, 4, 20, 1 << 20, 1 << 20)


def _train_state(dev, n, seed):
    raw = proxy.train_arrays(proxy.bicycle_proxy(n=n, seed=seed))
    return S.from_params(convert.params_from_numpy(**raw, device=dev),
                         n + 64)


def test_train_kernels_match_plain(cuda):
    """Kernels 4-7 against their plain versions on the train route's own
    inputs (tolerances as in chip_smoke.py)."""
    st = _train_state(cuda, N, 2)
    cam = proxy.proxy_camera(W, H, device=cuda)
    gx, T = (W + 15) // 16, ((W + 15) // 16) * ((H + 15) // 16)
    p = st.params
    with torch.no_grad():
        prep = projection.preprocess_cols(p.xyz, p.get_scaling(),
                                          p.get_rotation(), cam,
                                          live_mask=st.live)
        colors = sh.sh_to_rgb(3, p.get_features(), p.xyz, cam.cam_center)
        cols = rast.train_columns(prep, p.get_opacity(), colors)
        table, cum, _ = ep1.ps1_table(cols, prep.valid, prep.depth)
        args = (table, cum, gx, 1 << 20, 1 << 20)
        ek, ep = ep1.expand_ps1(*args), ep1.expand_ps1_plain(*args)
        k = int(ek.kept)
        assert k == int(ep.kept) and k > 1000
        for name in ("tile", "depth", "attrs"):
            assert torch.equal(getattr(ek, name)[..., :k],
                               getattr(ep, name)[..., :k]), name

        key, dbits = fov.fused_key32(ek.tile, ek.depth, ek.kept[0], T)
        full, seg = fov.sort_pairs(key, dbits, ek.attrs, T, True)
        pairs = full[:9]
        ck, Tk, nk = bfw.blend_forward(pairs, seg, gx)
        cp, Tp, np_ = blend.blend_forward_plain(pairs, seg, gx)
        torch.testing.assert_close(ck, cp, rtol=0, atol=1e-4)
        torch.testing.assert_close(Tk, Tp, rtol=0, atol=1e-4)
        assert float((nk != np_).float().mean()) < 1e-3

        gen = torch.Generator(device=cuda).manual_seed(0)
        g_c = torch.randn(ck.shape, generator=gen, device=cuda)
        g_T = torch.randn(Tk.shape, generator=gen, device=cuda)
        gk = bfw.blend_backward(pairs, seg, gx, g_c, g_T, Tk, nk)
        gp = blend.blend_backward_plain(pairs, seg, gx, g_c, g_T, Tk, nk)
        row_max = gp.abs().amax(1, keepdim=True)
        assert bool(((gk - gp).abs() <= 1e-4 * row_max).all())
        assert torch.equal(gk, bfw.blend_backward(pairs, seg, gx, g_c, g_T,
                                                  Tk, nk))

        gid, vals = rast.gid_sorted_stream(gk, full[9].to(torch.int32),
                                           seg[-1], st.capacity)
        rk = sr.reduce_by_sorted_gid(gid, vals, st.capacity)
        rp = sr.reduce_by_sorted_gid_plain(gid, vals, st.capacity)
        torch.testing.assert_close(
            rk, rp, rtol=1e-5, atol=1e-5 * float(rp.abs().max()))


def test_train_step_matches_cpu_and_counts_launches(cuda):
    """One photometric step's loss and gradients on the card against the
    CPU plain path, and one launch of each train kernel per step (SSIM's
    13 and 13b included)."""
    n, w, h = 5000, 160, 112
    gt = np.random.default_rng(1).uniform(0, 1, (h, w, 3)).astype(np.float32)
    cfg = loops.LoopConfig(raster=RasterizeConfig(pair_capacity=1 << 20))
    kernels = (ep1.expand_ps1, bfw.blend_forward, bfw.blend_backward,
               sr.reduce_by_sorted_gid, psh.project_sh_forward,
               psh.project_sh_backward, ssim_k.ssim_forward,
               ssim_k.ssim_backward)
    res = []
    for d in (cuda, torch.device("cpu")):
        st = _train_state(d, n, 3)
        before = [k.launches for k in kernels]
        loss, grads, n_bad, out = loops.photometric_grads(
            st, proxy.proxy_camera(w, h, device=d),
            torch.from_numpy(gt).to(d), cfg)
        res.append((loss, grads, n_bad, out,
                    [k.launches - b for k, b in zip(kernels, before)]))
    (lc, gc, bc, oc, nc), (lh, gh, bh, oh, nh) = res
    assert nc == [1] * 8 and nh == [0] * 8
    assert int(bc) == int(bh) == 0
    assert int(oc["binned"].overflow) == int(oh["binned"].overflow) == 0
    assert int(oc["binned"].num_pairs) == int(oh["binned"].num_pairs) > 1000
    torch.testing.assert_close(lc.cpu(), lh, rtol=1e-5, atol=0)
    for f, g in gh.items():
        scale = float(g.abs().max())
        torch.testing.assert_close(gc[f].cpu() / scale, g / scale,
                                   rtol=2e-3, atol=2e-4, msg=f)


def test_train_step_n_bad_counts_rows_with_cotangent(cuda):
    """_mask_dead_grads' n_bad, card against CPU, on a state with two live
    rows that reach no pixel and whose autograd gradient reads a NaN: one
    at the camera centre (a NaN view direction), one whose covariance
    overflows. The CPU counts both; kernel 10's backward gives a row
    without cotangent zero gradients, so the card counts neither. Every
    masked gradient still matches, those two rows zero on both."""
    n, w, h = 5000, 160, 112
    gt = np.random.default_rng(1).uniform(0, 1, (h, w, 3)).astype(np.float32)
    cfg = loops.LoopConfig(raster=RasterizeConfig(pair_capacity=1 << 20))
    raw = proxy.train_arrays(proxy.bicycle_proxy(n=n, seed=3))
    raw["xyz"][0] = proxy.proxy_camera(w, h, device="cpu").cam_center.numpy()
    raw["scaling"][1] = np.log(1e20)
    res = []
    for d in (cuda, torch.device("cpu")):
        st = S.from_params(convert.params_from_numpy(**raw, device=d),
                           n + 64)
        assert bool(st.live[:2].all())
        loss, grads, n_bad, out = loops.photometric_grads(
            st, proxy.proxy_camera(w, h, device=d),
            torch.from_numpy(gt).to(d), cfg)
        assert not bool(out["radii"][:2].any())
        res.append((loss, grads, int(n_bad)))
    (lc, gc, bc), (lh, gh, bh) = res
    assert bh == 2 and bc == 0
    torch.testing.assert_close(lc.cpu(), lh, rtol=1e-5, atol=0)
    for f, g in gh.items():
        assert not bool(g[:2].any()) and not bool(gc[f][:2].any()), f
        scale = float(g.abs().max())
        torch.testing.assert_close(gc[f].cpu() / scale, g / scale,
                                   rtol=2e-3, atol=2e-4, msg=f)


# Rows of project_case's cloud: behind the camera, at its centre, not
# live, zero scales (a zero determinant), huge finite scales, scales whose
# covariance overflows to inf and NaN.
BEHIND, CENTRE, DEAD, ZERO_DET, HUGE, OVERFLOW = range(6)


def project_case(dev, colors: bool, n=6000, w=W, h=H, seed=4):
    """Kernel 10's inputs on the proxy camera: the proxy cloud with the
    edge rows above, its activated parameters, 16 SH coefficients or
    given colours, the live mask and a pixel offset; and nine cotangent
    rows, zero on every fifth row, the centre and the overflow rows (the
    rows whose autograd gradient reads a NaN)."""
    st = _train_state(torch.device("cpu"), n, seed)
    p = st.params
    n = st.capacity
    c = proxy.proxy_camera(w, h, device="cpu").cam_center
    xyz = p.xyz.detach().clone()
    xyz[BEHIND] = c + 0.5 * c
    xyz[CENTRE] = c
    xyz[HUGE] = 0.0        # the point the camera looks at
    scales = p.get_scaling().detach().clone()
    scales[ZERO_DET] = 0.0
    scales[HUGE] = 1e4
    scales[OVERFLOW] = 1e20
    live = st.live.clone()
    live[DEAD] = False
    rng = np.random.default_rng(seed)
    g = torch.from_numpy(rng.normal(size=(9, n)).astype(np.float32))
    g[:, ::5] = 0.0
    g[:, [CENTRE, OVERFLOW]] = 0.0
    args = dict(
        means3d=xyz, scales=scales, rotations=p.get_rotation().detach(),
        opacities=p.get_opacity().detach(),
        colors=(torch.from_numpy(rng.uniform(0, 1, (n, 3))
                                 .astype(np.float32)) if colors else None),
        live_mask=live,
        mean2d_offset=torch.from_numpy(
            rng.normal(0, 0.1, (n, 2)).astype(np.float32)))
    args = {k: None if v is None else v.to(dev) for k, v in args.items()}
    args["shs"] = None if colors else (p.get_features().detach().to(dev),
                                       None)
    return args, proxy.proxy_camera(w, h, device=dev), g.to(dev)


def _same_bits(a, b):
    """Equal element for element, NaN where the other is NaN."""
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(a[~nan], b[~nan])


@pytest.mark.parametrize("colors", [False, True])
@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_project_sh_forward_matches_plain(cuda, degree, colors):
    """Kernel 10's forward against its plain twin on the card: the rect,
    tile count, OBB columns, valid and radius bit for bit; the
    differentiable columns within 1e-6 relative."""
    args, cam, _ = project_case(cuda, colors)
    with torch.no_grad():
        k = psh.project_sh_forward(camera=cam, sh_degree=degree, **args)
        p = psh.project_sh_plain(camera=cam, sh_degree=degree, **args)
    for r, name in enumerate(psh.AUX_ROWS):
        assert _same_bits(k.aux[r], p.aux[r]), name
    assert torch.equal(k.valid, p.valid)
    assert _same_bits(k.radius, p.radius) and _same_bits(k.depth, p.depth)
    for r, name in enumerate(psh.DIFF_ROWS):
        torch.testing.assert_close(k.diff[r], p.diff[r], rtol=1e-6, atol=0,
                                   equal_nan=True, msg=name)
    v = p.valid.cpu()
    assert not bool(v[[BEHIND, CENTRE, DEAD, ZERO_DET, OVERFLOW]].any())
    assert int(v.sum()) > 1000 and bool(v[HUGE])
    if not colors:
        # The SH as the model stores them, (N, 1, 3) and (N, 15, 3) (the
        # staging's 16-byte words cross rows), and for degree <= 2 nine
        # stored coefficients, rows 108 B apart (moved word by word).
        sh_ = args["shs"][0]
        forms = [(sh_[:, :1].contiguous(), sh_[:, 1:].contiguous())]
        if degree <= 2:
            forms.append((sh_[:, :9].contiguous(), None))
        for form in forms:
            with torch.no_grad():
                other = psh.project_sh_forward(
                    camera=cam, sh_degree=degree, **{**args, "shs": form})
            assert _same_bits(other.diff, k.diff)


@pytest.mark.parametrize("colors", [False, True])
@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_project_sh_backward_matches_autograd(cuda, degree, colors):
    """Kernel 10's backward against torch.autograd.grad of its plain twin
    on the card, for each of the five inputs and the pixel offset: within
    1e-5 of each gradient column's largest value where autograd is
    finite; finite everywhere; zero on rows without a cotangent and on
    coefficients above the degree; two calls bit-identical."""
    args, cam, g = project_case(cuda, colors)
    names = ["means3d", "scales", "rotations", "opacities",
             "colors" if colors else "shs", "mean2d_offset"]
    ins = {f: (args[f][0] if f == "shs" else args[f]).clone()
           .requires_grad_(True) for f in names}
    run = {**args, **ins}
    if not colors:
        run["shs"] = (ins["shs"], None)
    ref = torch.autograd.grad(
        psh.project_sh_plain(camera=cam, sh_degree=degree, **run).diff,
        list(ins.values()), g)
    got = [torch.autograd.grad(
        psh.project_sh(camera=cam, sh_degree=degree, **run).diff,
        list(ins.values()), g) for _ in range(2)]
    zero = (g == 0).all(0)
    for name, a, b, again in zip(names, got[0], ref, got[1]):
        assert torch.equal(a, again), name
        assert bool(torch.isfinite(a).all()), name
        assert bool((a[zero] == 0).all()), name
        a2, b2 = a.reshape(a.shape[0], -1), b.reshape(b.shape[0], -1)
        ok = torch.isfinite(b2).all(1)
        scale = b2[ok].abs().amax(0)
        assert bool(((a2[ok] - b2[ok]).abs() <= 1e-5 * scale).all()), name
    if not colors:
        nc = (degree + 1) ** 2
        assert not bool(got[0][4][:, nc:].any())
        assert bool(got[0][4][:, :nc].any())
    if not colors:
        # The model's (N, 1, 3) and (N, 15, 3) pair, and for degree <= 2
        # nine stored coefficients: the other staging paths, both ways.
        sh_ = args["shs"][0]
        forms = [[sh_[:, :1], sh_[:, 1:]]]
        if degree <= 2:
            forms.append([sh_[:, :9]])
        for form in forms:
            leaves = [f.clone().requires_grad_(True) for f in form]
            shs = (leaves[0], leaves[1] if len(leaves) > 1 else None)
            other = torch.autograd.grad(
                psh.project_sh(camera=cam, sh_degree=degree,
                               **{**args, **ins, "shs": shs}).diff,
                [*(ins[f] for f in names if f != "shs"), *leaves], g)
            for name, a in zip([f for f in names if f != "shs"], other):
                assert torch.equal(a, got[0][names.index(name)]), name
            d_sh = torch.cat(other[len(names) - 1:], 1)
            assert torch.equal(d_sh, got[0][4][:, :d_sh.shape[1]])


def test_blend_stats_matches_plain(cuda):
    """Kernel 8 against its plain version on the score route's pairs:
    integer rows, best_lane and first_trig exact, float rows 1e-5
    relative, the blend within T_EPS; two launches bit-identical."""
    st = _train_state(cuda, N, 2)
    cam = proxy.proxy_camera(W, H, device=cuda)
    gx, gy = (W + 15) // 16, (H + 15) // 16
    p = st.params
    with torch.no_grad():
        prep = projection.preprocess_cols(p.xyz, p.get_scaling(),
                                          p.get_rotation(), cam,
                                          live_mask=st.live)
        colors = sh.sh_to_rgb(3, p.get_features(), p.xyz, cam.cam_center)
        pairs, bn = binning.bin_fused_ps1(
            rast.train_columns(prep, p.get_opacity(), colors), prep.valid,
            prep.depth, gx, gy, 1 << 20)
        seg = bn.seg_start
        k = bs.blend_stats(pairs, seg, gx, W, H)
        q = blend.blend_stats_plain(pairs, seg, gx, W, H)
        torch.testing.assert_close(k[0], q[0], rtol=0, atol=1e-4)
        torch.testing.assert_close(k[1], q[1], rtol=0, atol=1e-4)
        assert torch.equal(k[2][1], q[2][1]) and torch.equal(k[2][3], q[2][3])
        torch.testing.assert_close(k[2][0::2], q[2][0::2], rtol=1e-5,
                                   atol=1e-7)
        assert torch.equal(k[3], q[3]) and torch.equal(k[5], q[5])
        torch.testing.assert_close(k[4], q[4], rtol=1e-5, atol=1e-7)
        assert float(k[2][1].sum()) > 1e4
        again = bs.blend_stats(pairs, seg, gx, W, H)
        assert all(torch.equal(a, b) for a, b in zip(k, again))


def test_score_and_hvs_step_match_cpu(cuda):
    """The score pass (its gs_count exact, contribs and the three metrics
    within 1e-5 relative) and one masked HVS step on the card against
    the CPU plain path."""
    n, w, h = 5000, 160, 128
    gt = np.random.default_rng(1).uniform(0, 1, (h, w, 3)).astype(np.float32)
    cfg = loops.LoopConfig(raster=RasterizeConfig(pair_capacity=1 << 20))
    res = []
    for d in (cuda, torch.device("cpu")):
        st = _train_state(d, n, 3)
        cam = proxy.proxy_camera(w, h, device=d)
        p = st.params
        outs = [stats.rasterize_stats(
            p.xyz, p.get_scaling(), p.get_rotation(), p.get_opacity(), cam,
            shs=p.get_features(), mode=m, config=cfg.raster,
            live_mask=st.live) for m in stats.MODES]
        scores = [loops.make_score_fn(cfg, m)(st, cam)[0].cpu()
                  for m in ("max_comp_efficiency", "max_contrib", "surface")]
        new, aux = loops.make_hvs_step(cfg, 3.0, masking=True, device=d)(
            st, cam, torch.from_numpy(gt).to(d), 1)
        res.append((outs, scores, new, aux))
    (oc, sc, nc, ac), (oh, sh_, nh, ah) = res
    for a, b in zip(oc, oh):
        assert int(a["binned"].overflow) == int(b["binned"].overflow) == 0
        assert torch.equal(a["gs_count"].cpu(), b["gs_count"])
        torch.testing.assert_close(a["contribs"].cpu(), b["contribs"],
                                   rtol=1e-5, atol=1e-7)
    for a, b in zip(sc, sh_):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)
    assert int(ac["overflow"]) == int(ah["overflow"]) == 0
    assert int(ac["nonfinite"]) == int(ah["nonfinite"]) == 0
    torch.testing.assert_close(ac["loss"].cpu(), ah["loss"], rtol=1e-5,
                               atol=0)
    for f in ("features_dc", "opacity"):
        g = nh.opt.mu[f]
        scale = float(g.abs().max())
        torch.testing.assert_close(nc.opt.mu[f].cpu() / scale, g / scale,
                                   rtol=2e-3, atol=2e-4, msg=f)


def _ps1_model(dev, n=N, seed=2):
    sc = proxy.bicycle_proxy(n=n, seed=seed)
    return convert.ps1_model_from_numpy(
        sc["means"], sc["scales"], sc["rotations"], sc["opacity"],
        sc["shs_dcs"][:, 0:1], sc["shs_rest"], device=dev)


def test_inference_kernels_match_plain(cuda):
    """Kernel 1's ps1 mode (integer rows and cum exact, floats 1e-5
    relative), kernel 4's quantized rows (bit-identical), kernel 5q over
    segments with every third tile emptied (within T_EPS) and kernel 9 on
    the ps1 table (bit-identical) against their plain versions."""
    model = _ps1_model(cuda)
    cam = proxy.proxy_camera(W, H, device=cuda)
    gx, T = (W + 15) // 16, ((W + 15) // 16) * ((H + 15) // 16)
    tk, ck, totk = bt.build_table_ps1(model, cam)
    tp, cp, totp = bt.build_table_ps1_plain(model, cam)
    assert torch.equal(ck, cp) and torch.equal(totk, totp)
    for r in (ep1.ROW_RX0, ep1.ROW_RY0, ep1.ROW_RW, ep1.ROW_TNUM):
        assert torch.equal(tk[r], tp[r]), r
    torch.testing.assert_close(tk, tp, rtol=1e-5, atol=1e-5)

    args = (tk, ck, gx, 1 << 20, 1 << 20)
    ek = ep1.expand_ps1(*args, quantize=True)
    ep = ep1.expand_ps1_plain(*args, quantize=True)
    k = int(ek.kept)
    assert k == int(ep.kept) and k > 1000
    assert torch.equal(ek.tile[:k], ep.tile[:k])
    assert torch.equal(ek.depth[:k], ep.depth[:k])
    assert torch.equal(ek.attrs[:, :k].view(torch.int32),
                       ep.attrs[:, :k].view(torch.int32))

    key, dbits = fov.fused_key32(ek.tile, ek.depth, ek.kept[0], T)
    pairs, seg = fov.sort_pairs(key, dbits, ek.attrs, T, False)
    ss = seg[:-1]
    se = torch.where(torch.arange(T, device=cuda) % 3 != 0, seg[1:], ss)
    for a, b in zip(bfw.blend_forward_q(pairs, ss, se, gx),
                    blend.blend_forward_q_plain(pairs, ss, se, gx)):
        if a.dtype == torch.int32:
            assert float((a != b).float().mean()) < 1e-3
        else:
            torch.testing.assert_close(a, b, rtol=0, atol=1e-4)

    ok_ = ct.compact_table(tk, ep1.ROW_TNUM, 0.5, ep1.ROW_TNUM)
    op_ = ct.compact_table_plain(tk, ep1.ROW_TNUM, 0.5, ep1.ROW_TNUM)
    assert all(torch.equal(a, b) for a, b in zip(ok_, op_))
    assert 0 < int(ok_[2]) < model.xyz.shape[0]


def test_shared_layout_and_fov_compaction_match_plain(cuda):
    """Kernels 1 and 2 on the SM-FR shared layout (L_lay = 1), and kernel
    9 on the fov table, against their plain versions."""
    sc = proxy.bicycle_proxy(n=N, seed=2)
    model = convert.fov_model_from_numpy(
        sc["means"], sc["scales"], sc["rotations"], sc["opacities4"],
        sc["shs_dcs"], sc["shs_rest"], sc["highest_levels"], device=cuda,
        shared_colors=True)
    _, cam, levels, bbox = _scene(cuda, (0.5, 0.5))
    gx = (W + 15) // 16
    tk, ck, totk = bt.build_table(model, cam, bbox)
    tp, cp, totp = bt.build_table_plain(model, cam, bbox)
    assert tk.shape[0] == bt.num_rows(1)
    assert torch.equal(ck, cp) and torch.equal(totk, totp)
    torch.testing.assert_close(tk, tp, rtol=1e-5, atol=1e-5)
    args = (tk, ck, levels, 4, gx, 1 << 20, 1 << 20)
    ek, ep = ef.expand_fov(*args), ef.expand_fov_plain(*args)
    k = int(ek.kept)
    assert k == int(ep.kept) and k > 1000
    assert torch.equal(ek.tile[:k], ep.tile[:k])
    assert torch.equal(ek.attrs[:, :k], ep.attrs[:, :k])

    ok_ = ct.compact_table(tk, bt.ROW_VALID, 0.5, bt.ROW_TNUM)
    op_ = ct.compact_table_plain(tk, bt.ROW_VALID, 0.5, bt.ROW_TNUM)
    assert all(torch.equal(a, b) for a, b in zip(ok_, op_))
    assert int(ok_[3]) == int(totk)


def test_inference_frames_match_cpu_and_count_launches(cuda):
    """The PS1, SM-FR and MM-FR frames on the card against the CPU plain
    path (within 1e-4), and their kernels launched on the card only."""
    sc = proxy.bicycle_proxy(n=N, seed=2)
    gaze = (0.4, 0.6)
    kernels = (bt.build_table_ps1, bt.build_table, ef.expand_fov,
               bf.blend_fov, ep1.expand_ps1, bfw.blend_forward_q,
               ct.compact_table)
    res = []
    for d in (cuda, torch.device("cpu")):
        cam = proxy.proxy_camera(W, H, device=d)
        g = torch.tensor(gaze, device=d)
        before = [k.launches for k in kernels]
        cfg = RasterizeConfig(pair_capacity=1 << 20, compact_table=True)
        ps1 = rast.rasterize_ps1_soa(_ps1_model(d), cam, bg_color=[0.1] * 3,
                                     config=cfg)
        shared = convert.fov_model_from_numpy(
            sc["means"], sc["scales"], sc["rotations"], sc["opacities4"],
            sc["shs_dcs"], sc["shs_rest"], sc["highest_levels"], device=d,
            shared_colors=True)
        smfr = fov.rasterize_fov_soa(shared, cam, g, 0.05, config=cfg)
        models = convert.mmfr_models_from_numpy(
            sc["means"], sc["scales"], sc["rotations"], sc["opacities4"],
            sc["shs_dcs"], sc["highest_levels"], device=d)
        mm, diags = mmfr.render_mmfr(models, cam, g, 0.05, cfg,
                                     return_diag=True)
        res.append(([o["render"].cpu() for o in (ps1, smfr)] + [mm.cpu()],
                    [int(ps1["num_pairs"]), int(smfr["num_pairs"])]
                    + [int(x["num_pairs"]) for x in diags],
                    [k.launches - b for k, b in zip(kernels, before)]))
    (ic, nc, lc), (ih, nh, lh) = res
    assert nc == nh and min(nc[:2]) > 1000
    assert all(x > 0 for x in lc) and all(x == 0 for x in lh)
    for a, b in zip(ic, ih):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4)


# The MM-FR level models in the packed SH form: the ladder of
# ours-Q/bicycle.txt scaled to N rows.
MMFR_PNUM = [N, N * 465_471 // 1_161_358, N * 252_678 // 1_161_358,
             N * 202_263 // 1_161_358]


def _mmfr_sh_models(dev):
    sc = {k: torch.as_tensor(v, device=dev)
          for k, v in proxy.bicycle_proxy(n=N, seed=2).items()}
    return mmfr.pack_level_models(
        sc["means"], sc["scales"], sc["rotations"], sc["opacities4"],
        sc["shs_dcs"], sc["shs_rest"], sc["highest_levels"], MMFR_PNUM)


@pytest.mark.parametrize("gaze", [(0.5, 0.5), (0.2, 0.8)])
def test_build_table_ps1_box_matches_plain(cuda, gaze):
    """Kernel 1p with each MM-FR pass's owned-tile box against its plain
    twin (integer rows and cum exact, floats 1e-5 relative), rows of
    opacity below 1/255 culled; without a box, the rows the box leaves
    whole are the same columns."""
    models = _mmfr_sh_models(cuda)
    m0 = models[0]
    op = m0.opac.clone()
    op[::11] = 0.003
    models[0] = dataclasses.replace(m0, opac=op)
    cam = proxy.proxy_camera(W, H, device=cuda)
    gx, gy = (W + 15) // 16, (H + 15) // 16
    levels = foveation.compute_tile_levels(
        torch.tensor(gaze, device=cuda), W, H, 0.3)
    boxes, _ = mmfr.tile_ownership(levels.to(torch.int32), gx, gy, 4)
    kept = 0
    for m, box in zip(models, boxes):
        tk, ck, totk = bt.build_table_ps1(m, cam, box=box)
        tp, cp, totp = bt.build_table_ps1_plain(m, cam, box=box)
        assert torch.equal(ck, cp) and torch.equal(totk, totp)
        for r in (ep1.ROW_RX0, ep1.ROW_RY0, ep1.ROW_RW, ep1.ROW_TNUM):
            assert torch.equal(tk[r], tp[r]), r
        torch.testing.assert_close(tk, tp, rtol=1e-5, atol=1e-5)
        t0 = bt.build_table_ps1(m, cam)[0]
        whole = ((t0[ep1.ROW_RX0] >= box[0]) & (t0[ep1.ROW_RY0] >= box[1])
                 & (t0[ep1.ROW_RX0] + t0[ep1.ROW_RW] <= box[2])
                 & (t0[ep1.ROW_TNUM] > 0)
                 & (m.opac.float() >= 1.0 / 255.0))
        whole &= (t0[ep1.ROW_RY0] + t0[ep1.ROW_TNUM] / t0[ep1.ROW_RW]
                  <= box[3])
        assert torch.equal(tk[:, whole], t0[:, whole])
        kept += int((tk[ep1.ROW_TNUM] > 0).sum())
    assert kept > 1000


def test_mmfr_sh_frame_graphs_and_splits(cuda):
    """The MM-FR frame of the packed SH form as one CUDA graph: equal to
    its eager function bit for bit at two gazes, one capture; each replay
    launches kernels 1p, 4q and 5q four times, once a pass; a profiled
    replay matches its stage map (levels, pass0-3 with their table,
    expand, sort, gather and blend, sum), with no device operation
    outside a stage."""
    from torch.profiler import ProfilerActivity, profile
    from fovsplat_torch.eval import fps
    from fovsplat_torch.utils import profiling
    cfg = RasterizeConfig(pair_capacity=1 << 20)
    frame = fps.make_mmfr_render(_mmfr_sh_models(cuda), cfg, alpha=0.3)
    cam = proxy.proxy_camera(W, H, device=cuda)
    counters = _set_counters()
    for gz in ((0.4, 0.6), (0.2, 0.2)):
        g = torch.tensor(gz, device=cuda)
        a, b = frame(cam, g), frame.eager(cam, g)
        for k in ("render", "num_pairs", "overflow"):
            assert torch.equal(a[k], b[k]), (gz, k)
        assert [int(d["num_pairs"]) for d in a["passes"]] == \
            [int(d["num_pairs"]) for d in b["passes"]]
        assert int(a["overflow"]) == 0
        assert sum(int(d["num_pairs"]) > 0 for d in a["passes"]) >= 3
    assert frame.graph.captures == 1
    per = frame.graph.launches_per_replay
    assert per == {"build_table_ps1": 4, "expand_ps1": 4,
                   "blend_forward_q": 4}
    _set_counters()
    g = torch.tensor((0.5, 0.5), device=cuda)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            frame(cam, g)
        torch.cuda.synchronize()
    assert {k: getattr(o, a) for k, (o, a) in counters.items()} == {
        k: 3 * per.get(k, 0) for k in counters}
    report = profiling.window_report(list(prof.events()))
    rec = frame.graph.record
    rg = report["graphs"][str(rec.serial)]
    assert rg["replays"] == 3 and rg["unmatched"] == 0, report
    want = {"levels", "sum"} | {f"pass{li}/{st}" for li in range(4)
                                for st in ("table", "expand", "sort",
                                           "gather", "blend")}
    assert want <= set(rg["stage_s"]), sorted(rg["stage_s"])
    assert "other" not in rg["stage_s"]
    assert {lb for lb, *_ in rec.stages} <= want | {
        f"pass{li}" for li in range(4)}


def _ps1_edge_table(dev, case, gx=20, gy=14, n=3000, seed=9):
    """A ps1 table (ps1_table's layout) of random rects on a gx x gy grid:
    "whole_grid" puts three Gaussians whose rects cover the whole grid
    among one-tile rects (len1 = 0, kept without a test); "all_invalid"
    masks every row; else rects of 1 to 6 x 1 to 5 tiles."""
    rng = np.random.default_rng(seed)
    rw = rng.integers(1, 7, n)
    rh = rng.integers(1, 6, n)
    if case == "whole_grid":
        rw[:] = 1
        rh[:] = 1
    rx0 = rng.integers(0, gx, n)
    ry0 = rng.integers(0, gy, n)
    rw = np.minimum(rw, gx - rx0)
    rh = np.minimum(rh, gy - ry0)
    theta = rng.uniform(0, np.pi, n)
    len1 = rng.uniform(4, 60, n)
    len2 = len1 * rng.uniform(0.1, 1.0, n)
    if case == "whole_grid":
        big = np.array([7, n // 2, n - 1])
        rx0[big], ry0[big], rw[big], rh[big] = 0, 0, gx, gy
        len1[:] = 0.0
        len2[:] = 0.0
        len1[big] = rng.uniform(60, 200, 3)
        len2[big] = len1[big] * 0.5
    mx = (rx0 + rw * rng.uniform(0, 1, n)) * 16
    my = (ry0 + rh * rng.uniform(0, 1, n)) * 16
    cols = [rx0, ry0, rw, rw * rh, mx, my, np.cos(theta), np.sin(theta),
            -np.sin(theta), np.cos(theta), len1, len2,
            rng.uniform(0.01, 0.2, n), rng.uniform(-0.01, 0.01, n),
            rng.uniform(0.01, 0.2, n), rng.uniform(0, 1, n),
            rng.uniform(-0.2, 1.2, n), rng.uniform(0, 1, n),
            rng.uniform(0, 1, n)]
    cols = [torch.tensor(np.asarray(c, np.float32), device=dev) for c in cols]
    valid = torch.tensor(rng.uniform(0, 1, n) > 0.1, device=dev)
    if case == "all_invalid":
        valid[:] = False
    depth = torch.tensor(rng.uniform(0.5, 50, n).astype(np.float32),
                         device=dev)
    return ep1.ps1_table(cols, valid, depth)


def _ps1_exact(args, quantize):
    """Kernel 4 (4q) and its plain version on `args`: kept, the first
    min(kept, cap_out) lanes of tile, depth and the rows' bits, and the
    sorted keys; a second launch bit-identical."""
    ek = ep1.expand_ps1(*args, quantize=quantize)
    ep = ep1.expand_ps1_plain(*args, quantize=quantize)
    again = ep1.expand_ps1(*args, quantize=quantize)
    kept = int(ek.kept)
    assert kept == int(ep.kept) == int(again.kept)
    k = min(kept, args[-1])
    for name in ("tile", "depth", "attrs"):
        a, b, c = (getattr(e, name)[..., :k].contiguous().view(torch.int32)
                   for e in (ek, ep, again))
        assert torch.equal(a, b) and torch.equal(a, c), name
    return ek


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("case", ["pair_capacity", "cap_out", "whole_grid",
                                  "all_invalid"])
def test_expand_ps1_edge_cases_match_plain(cuda, case, quantize):
    """Kernel 4 and 4q, candidate-parallel, bit for bit against
    expand_ps1_plain: a pair capacity that ends inside a Gaussian's rect,
    a kept-pair capacity below the kept count, rects over the whole grid
    beside one-tile rects, and a table with no valid row."""
    gx, gy = 20, 14
    table, cum, total = _ps1_edge_table(
        cuda, "whole_grid" if case == "whole_grid" else
        "all_invalid" if case == "all_invalid" else "rects", gx, gy)
    full = _ps1_exact((table, cum, gx, 1 << 20, 1 << 20), quantize)
    kept = int(full.kept)
    if case == "all_invalid":
        assert int(total) == 0 and kept == 0
        return
    assert 1000 < kept <= int(total)
    if case == "pair_capacity":
        c, tnum = cum.long(), table[ep1.ROW_TNUM].long()
        g = int(((c >= int(total) // 2) & (tnum > 2)).nonzero()[0])
        cap = int(c[g]) + int(tnum[g]) // 2
        ek = _ps1_exact((table, cum, gx, cap, 1 << 20), quantize)
        assert 0 < int(ek.kept) < kept
    elif case == "cap_out":
        cap_out = kept // 2 + 3
        ek = _ps1_exact((table, cum, gx, 1 << 20, cap_out), quantize)
        assert int(ek.kept) == kept
        assert torch.equal(ek.tile[:cap_out], full.tile[:cap_out])
    else:
        # The three whole-grid rects are walked tile by tile.
        assert int(table[ep1.ROW_TNUM].max()) == gx * gy


def _blend_edge_case(dev, case, gx=4, gy=3):
    """Sorted pairs (expand_fov.ATTR_ROWS), segments and masks on a gx x
    gy grid: "deep" gives tile 5 more than three staging batches of
    faint pairs among empty tiles, "no_l2" a tile with pairs and no
    L2-active pixel, "inactive" no active pixel in either chain."""
    rng = np.random.default_rng(4)
    T = gx * gy
    counts = np.zeros(T, np.int64)
    if case == "deep":
        counts[5] = 1100
        counts[10] = 7
    else:
        counts[:] = rng.integers(0, 90, T)
        counts[3] = 0
    seg = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    tile = np.repeat(np.arange(T), counts)
    m = int(seg[-1])
    pairs = np.zeros((13, m), np.float32)
    pairs[0] = (tile % gx) * 16 + rng.uniform(-4, 20, m)
    pairs[1] = (tile // gx) * 16 + rng.uniform(-4, 20, m)
    pairs[2] = rng.uniform(0.005, 0.08, m)
    pairs[3] = rng.uniform(-0.004, 0.004, m)
    pairs[4] = rng.uniform(0.005, 0.08, m)
    faint = 0.06 if case == "deep" else 0.6
    pairs[5] = rng.uniform(0.0, faint, m)
    pairs[6] = np.where(rng.uniform(0, 1, m) < 0.2, -1.0,
                        rng.uniform(0.0, faint, m))
    pairs[7:13] = rng.uniform(0, 1, (6, m))
    pairs = np.concatenate([pairs, np.zeros((13, 17), np.float32)], 1)
    l1 = rng.uniform(0, 1, (T, 256)) < 0.9
    l2 = rng.uniform(0, 1, (T, 256)) < 0.5
    if case == "no_l2":
        l2[7] = False
    if case == "inactive":
        l1[:] = False
        l2[:] = False
    return (torch.from_numpy(pairs).to(dev), torch.from_numpy(seg).to(dev),
            torch.from_numpy(l1).to(dev), torch.from_numpy(l2).to(dev))


@pytest.mark.parametrize("case", ["deep", "no_l2", "inactive"])
def test_blend_fov_edge_tiles_match_plain(cuda, case):
    """Kernel 3 against blend_fov_plain within T_EPS, and two launches
    bit-identical: a tile of more than three staging batches among empty
    tiles, a tile with no L2-active pixel, and no active pixel at all."""
    gx = 4
    pairs, seg, l1, l2 = _blend_edge_case(cuda, case, gx)
    k = bf.blend_fov(pairs, seg, l1, l2, gx)
    p = bf.blend_fov_plain(pairs, seg, l1, l2, gx)
    for a, b in zip(k, p):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4)
    assert all(torch.equal(a, b)
               for a, b in zip(k, bf.blend_fov(pairs, seg, l1, l2, gx)))
    c1, t1, c2, t2 = k
    if case == "inactive":
        assert not bool(c1.any() or c2.any())
        assert bool((t1 == 1).all() and (t2 == 1).all())
    elif case == "no_l2":
        assert bool((t2[7] == 1).all()) and float(t1[7].min()) < 0.9
    else:
        # The deep tile's pixels blend well past the first batches.
        assert float(t1[5][l1[5]].max()) < 0.5 and bool((t1[0] == 1).all())


def test_fps_benchmark_keys_and_forms(cuda):
    """fps_benchmark's six keys in both forms: per_gaze is per_gaze_fps,
    avg their mean, per_gaze_ms their inverse in ms."""
    from fovsplat_torch.eval import fps
    model, cam, _, _ = _scene(cuda, (0.5, 0.5))
    render = fps.make_fov_render(model, RasterizeConfig(
        pair_capacity=1 << 20))
    gazes = [(0.5, 0.5), (0.2, 0.8)]
    for kw in (dict(warmups=1, reps=2), dict(sync_every_rep=True)):
        res = fps.fps_benchmark(render, [cam], gazes=gazes,
                                log=lambda *_: None, **kw)
        assert set(res) == {"per_gaze_ms", "per_gaze_fps", "avg_ms",
                            "avg_fps", "per_gaze", "avg"}
        assert res["per_gaze"] == res["per_gaze_fps"] and len(
            res["per_gaze"]) == 2
        assert res["avg"] == pytest.approx(float(np.mean(res["per_gaze"])),
                                           rel=1e-12)
        assert res["avg"] == res["avg_fps"]
        for ms, f in zip(res["per_gaze_ms"], res["per_gaze"]):
            assert ms > 0 and f == pytest.approx(1000.0 / ms, rel=1e-12)


# Edge cases of the single-chain blends (kernels 5, 5q and 8), also held
# against the JAX kernels on the CPU by tests/test_torch_blend_edges.py.
TIE_OPS = (0.2, 0.25)   # w = 0.2 * 1 and 0.25 * (1 - 0.2): equal in f32


def _tile_pairs(rng, t, gx, n, op_hi, sweep=False, conic=(0.005, 0.08)):
    """(9, n) rows [mx, my, ca, cb, cc, op, r, g, b] of n pairs over tile
    t; with `sweep`, their means walk across the tile from left to right
    in segment order."""
    x0, y0 = (t % gx) * 16, (t // gx) * 16
    mx = (x0 + np.linspace(-2.0, 18.0, n) + rng.uniform(-1, 1, n) if sweep
          else x0 + rng.uniform(-4, 20, n))
    return np.stack([mx, y0 + rng.uniform(-4, 20, n),
                     rng.uniform(*conic, n), rng.uniform(-0.004, 0.004, n),
                     rng.uniform(*conic, n), rng.uniform(0.0, op_hi, n),
                     *rng.uniform(0, 1, (3, n))]).astype(np.float32)


def single_edge_case(case, seed=5):
    """Sorted single-chain pair rows (9, CAP) f32 with CAP a multiple of
    128 past the last segment, segment bounds (T+1,) i32, the frame
    (gx, gy, width, height) and the lanes of the tie pairs. Cases:
    "deep": one tile of 1,100 opaque pairs that freezes within its first
    batch, among empty tiles and a short one; "staggered": a tile whose
    pairs sweep across it, so its pixels freeze batches apart; "border":
    a 70x45 frame (edge tiles with pixels outside it); "ties": pairs
    whose weights tie exactly at their centre pixels (TIE_OPS, lowest
    lane wins), ahead of faint pairs; "zero_pairs": no pair at all."""
    rng = np.random.default_rng(seed)
    gx, gy, width, height = 4, 3, 64, 48
    if case == "border":
        gx, gy, width, height = 5, 3, 70, 45
    T = gx * gy
    tiles, ties = [[] for _ in range(T)], []
    if case == "deep":
        tiles[5].append(_tile_pairs(rng, 5, gx, 1100, 0.9,
                                    conic=(0.005, 0.03)))
        tiles[10].append(_tile_pairs(rng, 10, gx, 7, 0.6))
    elif case == "staggered":
        tiles[5].append(_tile_pairs(rng, 5, gx, 900, 0.95, sweep=True,
                                    conic=(0.05, 0.2)))
        tiles[2].append(_tile_pairs(rng, 2, gx, 40, 0.6))
    elif case == "border":
        for t in range(T):
            tiles[t].append(_tile_pairs(rng, t, gx, int(rng.integers(0, 120)),
                                        0.6))
        tiles[7] = []
    elif case == "needles":
        # Elongated, rotated footprints whose windows end inside a tile:
        # the warps' window-block cull must skip no pair that reaches one
        # of their pixels.
        for t in range(T):
            n = int(rng.integers(60, 160))
            s1 = np.exp(rng.uniform(np.log(0.5), np.log(60.0), n))
            s2 = rng.uniform(0.5, 3.0, n)
            th = rng.uniform(0, np.pi, n)
            c, s = np.cos(th), np.sin(th)
            sxx = c * c * s1 ** 2 + s * s * s2 ** 2 + 0.3
            syy = s * s * s1 ** 2 + c * c * s2 ** 2 + 0.3
            sxy = c * s * (s1 ** 2 - s2 ** 2)
            det = sxx * syy - sxy ** 2
            x0, y0 = (t % gx) * 16, (t // gx) * 16
            tiles[t].append(np.stack([
                x0 + rng.uniform(-30, 46, n), y0 + rng.uniform(-30, 46, n),
                syy / det, -sxy / det, sxx / det, rng.uniform(0.1, 0.9, n),
                *rng.uniform(0, 1, (3, n))]).astype(np.float32))
    elif case == "ties":
        for t in range(T):
            head = []
            if t in (1, 6):
                for k, (px, py) in enumerate(((2, 3), (7, 9), (12, 4),
                                              (13, 14))):
                    for op in TIE_OPS:
                        head.append([(t % gx) * 16 + px, (t // gx) * 16 + py,
                                     2.0, 0.0, 2.0, op, *rng.uniform(0, 1, 3)])
            if head:
                tiles[t].append(np.asarray(head, np.float32).T)
            if t == 9:   # opaque: its pixels freeze early
                tiles[t].append(_tile_pairs(rng, t, gx, 300, 0.95,
                                            conic=(0.005, 0.02)))
            else:
                tiles[t].append(_tile_pairs(rng, t, gx,
                                            int(rng.integers(20, 200)), 0.15))
    counts = [sum(a.shape[1] for a in tl) for tl in tiles]
    seg = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    m = int(seg[-1])
    if case == "ties":
        for t in (1, 6):
            ties += [int(seg[t]) + 2 * k for k in range(4)]
    cap = (m // 128 + 1) * 128
    rows = np.zeros((9, cap), np.float32)
    if m:
        rows[:, :m] = np.concatenate([a for tl in tiles for a in tl], 1)
    return rows, seg, (gx, gy, width, height), ties


def quantize_rows(rows):
    """Kernel 4q's five inference rows of (9, CAP) f32 pair rows, through
    expand_ps1.quantized_rows on a table holding them."""
    r = torch.as_tensor(rows)
    table = torch.zeros((ep1.NUM_ROWS, r.shape[1]), dtype=torch.float32)
    for i, row in enumerate((ep1.ROW_MX, ep1.ROW_MY, ep1.ROW_CA, ep1.ROW_CB,
                             ep1.ROW_CC, ep1.ROW_OP, ep1.ROW_R, ep1.ROW_G,
                             ep1.ROW_B)):
        table[row] = r[i]
    return ep1.quantized_rows(table).contiguous()


def q_segments(seg, case):
    """Kernel 5q's (seg_start, seg_end) (T,): "emptied" empties every
    third tile and halves tile 5, "all_empty" empties every tile."""
    ss, se = seg[:-1].copy(), seg[1:].copy()
    if case == "emptied":
        se[::3] = ss[::3]
        se[5] = ss[5] + (se[5] - ss[5]) // 2
    elif case == "all_empty":
        se = ss.copy()
    return ss, se


SINGLE_CASES = ([("fwd", c) for c in ("deep", "staggered", "border", "ties",
                                      "needles", "zero_pairs")]
                + [("fwd_q", c) for c in ("deep", "staggered", "border",
                                          "emptied", "all_empty", "needles",
                                          "zero_pairs")]
                + [("stats", c) for c in ("deep", "staggered", "border",
                                          "ties", "needles", "zero_pairs")]
                + [("bwd", c) for c in ("deep", "staggered", "border",
                                        "needles", "zero_pairs")])
BWD_RTOL = 1e-4   # kernel 6 vs plain, of each row's largest value


def _bwd_edge_case(pairs, seg, seg_np, gx, case):
    """Kernel 6 against its plain version on one single_edge_case frame,
    with seeded random colour and T cotangents and the plain forward's
    final T and n_contrib: within BWD_RTOL of each row's largest value,
    bit-identical over two launches, zero past the last segment and past
    each tile's deepest contributor."""
    T = seg.shape[0] - 1
    _, final_T, nc = blend.blend_forward_plain(pairs, seg, gx)
    rng = np.random.default_rng(11)
    g_c, g_T = (torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32))
                .to(pairs.device) for shape in ((T, blend.PIX, 3),
                                                (T, blend.PIX)))
    args = (pairs, seg, gx, g_c, g_T, final_T, nc)
    launches = bfw.blend_backward.launches
    gk, gp = bfw.blend_backward(*args), blend.blend_backward_plain(*args)
    row_max = gp.abs().amax(1, keepdim=True)
    assert bool(((gk - gp).abs() <= BWD_RTOL * row_max).all())
    assert torch.equal(gk, bfw.blend_backward(*args))
    if pairs.device.type == "cuda":
        assert bfw.blend_backward.launches == launches + 2
    m = int(seg_np[-1])
    assert not bool(gk[:, m:].any())
    for t in range(T):
        deep = int(seg_np[t]) + int(nc[t].max())
        assert not bool(gk[:, deep:int(seg_np[t + 1])].any())
    if case == "zero_pairs":
        assert not bool(gk.any())
    else:
        assert float(gk.abs().max()) > 0
    if case == "deep":
        # The deep tile's pixels froze within its first 128 pairs: its
        # rows past them are zero.
        assert int(nc[5].max()) < 128 < int(seg_np[6] - seg_np[5])


@pytest.mark.parametrize("kernel,case", SINGLE_CASES)
def test_single_chain_edge_cases_match_plain(cuda, kernel, case):
    """Kernels 5, 5q, 6 and 8 against their plain versions on the edge
    cases of single_edge_case (colour and T within T_EPS, n_contrib on all
    but a thousandth of the pixels; kernel 8's integer outputs exact, its
    float rows 1e-5 relative; kernel 6 as _bwd_edge_case) and
    bit-identical over two launches."""
    rows, seg_np, (gx, gy, width, height), ties = single_edge_case(
        "border" if case in ("emptied", "all_empty") else case)
    T = gx * gy
    seg = torch.from_numpy(seg_np).to(cuda)
    pairs = torch.from_numpy(rows).to(cuda)
    if kernel == "bwd":
        _bwd_edge_case(pairs, seg, seg_np, gx, case)
        return
    if kernel == "stats":
        args = (pairs, seg, gx, width, height)
        k, q = bs.blend_stats(*args), blend.blend_stats_plain(*args)
        torch.testing.assert_close(k[0], q[0], rtol=0, atol=1e-4)
        torch.testing.assert_close(k[1], q[1], rtol=0, atol=1e-4)
        assert torch.equal(k[2][1], q[2][1]) and torch.equal(k[2][3], q[2][3])
        torch.testing.assert_close(k[2][0::2], q[2][0::2], rtol=1e-5,
                                   atol=1e-7)
        assert torch.equal(k[3], q[3]) and torch.equal(k[5], q[5])
        torch.testing.assert_close(k[4], q[4], rtol=1e-5, atol=1e-7)
        assert all(torch.equal(a, b) for a, b in zip(k, bs.blend_stats(*args)))
        colour, final_T, st, best_lane, first_trig = k[0], k[1], k[2], k[3], k[5]
    else:
        if kernel == "fwd":
            args = (pairs, seg, gx)
            k, q = bfw.blend_forward(*args), blend.blend_forward_plain(*args)
            again = bfw.blend_forward(*args)
        else:
            ss, se = (torch.from_numpy(x).to(cuda)
                      for x in q_segments(seg_np, case))
            args = (quantize_rows(rows).to(cuda), ss, se, gx)
            k = bfw.blend_forward_q(*args)
            q = blend.blend_forward_q_plain(*args)
            again = bfw.blend_forward_q(*args)
        torch.testing.assert_close(k[0], q[0], rtol=0, atol=1e-4)
        torch.testing.assert_close(k[1], q[1], rtol=0, atol=1e-4)
        assert float((k[2] != q[2]).float().mean()) <= 1e-3
        assert all(torch.equal(a, b) for a, b in zip(k, again))
        colour, final_T, nc = k
    if case in ("zero_pairs", "all_empty"):
        assert bool((final_T == 1).all()) and not bool(colour.any())
        if kernel == "stats":
            assert bool((best_lane == pairs.shape[1]).all())
            assert bool((first_trig == blend.BIG).all()) and not st.any()
        else:
            assert not bool(nc.any())
    elif case == "deep":
        # The deep tile froze within its first batch of 128 records.
        assert float(final_T[5].max()) < 1e-2
        if kernel == "stats":
            assert int(first_trig[5].max()) < 128
            assert not st[:, int(seg_np[5]) + 128:int(seg_np[6])].any()
        else:
            assert int(nc[5].max()) < 128
    elif case == "staggered" and kernel != "stats":
        # Pixels of tile 5 freeze batches apart.
        assert int(nc[5].min()) < 256 < int(nc[5].max())
    elif case == "staggered":
        fired = first_trig[5][first_trig[5] < blend.BIG]
        assert int(fired.min()) < 128 < int(fired.max())
    elif case == "ties" and kernel == "stats":
        for t, lanes in ((1, ties[:4]), (6, ties[4:])):
            for lane, (px, py) in zip(lanes, ((2, 3), (7, 9), (12, 4),
                                              (13, 14))):
                assert int(best_lane[t, py * 16 + px]) == lane
    elif case == "border" and kernel == "stats":
        inside = blend.tile_inside_mask(gx, gy, width, height, cuda)
        assert not bool(inside.all())
        assert bool((final_T[~inside] == 1).all())
        assert bool((best_lane[~inside] == pairs.shape[1]).all())
    elif case == "emptied":
        emptied = torch.from_numpy(q_segments(seg_np, case)[1]
                                   == seg_np[:-1]).to(cuda)
        assert bool((final_T[emptied] == 1).all())
        assert float(final_T[~emptied].min()) < 0.9


COMPACT_CASES = ("none_kept", "all_kept", "ragged", "block_boundary",
                 "n_2_21")


def _compact_case(case, rows=20, flag_row=7, tnum_row=3, seed=4):
    """A (rows, n) f32 table for kernel 9: random payload, flag row 0 / 1,
    tnum row 0-39 tiles. "none_kept" and "all_kept": no column and every
    column flagged; "ragged": n not a multiple of a block's columns;
    "block_boundary": exactly the first two blocks' columns kept, so live
    ends at a block boundary; "n_2_21": 2^21 columns, 60% kept."""
    rng = np.random.default_rng(seed)
    n = {"n_2_21": 1 << 21, "ragged": 5 * ct.CHUNK + 77}.get(
        case, 6 * ct.CHUNK)
    table = rng.normal(0, 1, (rows, n)).astype(np.float32)
    flag = rng.uniform(0, 1, n) < 0.6
    if case == "none_kept":
        flag[:] = False
    elif case == "all_kept":
        flag[:] = True
    elif case == "block_boundary":
        flag[:] = False
        flag[:2 * ct.CHUNK] = True
    table[flag_row] = flag
    table[tnum_row] = rng.integers(0, 40, n)
    return table, flag_row, tnum_row, int(flag.sum())


@pytest.mark.parametrize("case", COMPACT_CASES)
def test_compact_table_edge_cases_match_plain(cuda, case):
    """Kernel 9 bit-identical to its plain version and over two launches,
    one launch counted a call."""
    table, flag_row, tnum_row, live = _compact_case(case)
    t = torch.from_numpy(table).to(cuda)
    launches = ct.compact_table.launches
    k = ct.compact_table(t, flag_row, 0.5, tnum_row)
    p = ct.compact_table_plain(t, flag_row, 0.5, tnum_row)
    assert all(torch.equal(a, b) for a, b in zip(k, p))
    assert all(torch.equal(a, b) for a, b in
               zip(k, ct.compact_table(t, flag_row, 0.5, tnum_row)))
    if t.device.type == "cuda":
        assert ct.compact_table.launches == launches + 2
    assert int(k[2]) == live
    assert not bool(k[0][:, live:].any())
    assert bool((k[1][live:] == k[3]).all())


# -------------------------------------------- scene I/O and densification

def test_knn_matches_cpu(cuda):
    """ops/knn on the card against its CPU run on the 100,000 centres of
    the scene phase's proxy: Morton codes exact, distances 1e-6 relative."""
    from fovsplat_torch.ops import knn
    pts = torch.from_numpy(proxy.bicycle_proxy(n=100_000, seed=1)["means"])
    np.testing.assert_array_equal(knn.morton_codes(pts.to(cuda)).cpu(),
                                  knn.morton_codes(pts))
    np.testing.assert_allclose(knn.mean_knn_sqdist(pts.to(cuda)).cpu(),
                               knn.mean_knn_sqdist(pts), rtol=1e-6)


@pytest.mark.parametrize("budget", [64, 4096])
def test_place_rows_matches_cpu_with_ties(cuda, budget):
    """densify._place_rows on the card against the CPU: priorities in
    four exact tie groups, dead slots between live rows; the same
    candidate lanes, placements, dropped count and rows."""
    from fovsplat_torch.models import densify as D
    from fovsplat_torch.models import gaussians as G
    rng = np.random.default_rng(budget)
    n, cap = 3000, 5000
    raw = proxy.train_arrays(proxy.bicycle_proxy(n=n, seed=3))
    kill = torch.from_numpy(rng.random(cap) < 0.1)
    prio = torch.from_numpy(rng.choice([1.0, 2.0, 3.0, 4.0], cap).astype(
        np.float32))
    want = torch.from_numpy(rng.random(cap) < 0.5)
    out = []
    for dev in (cuda, torch.device("cpu")):
        st = S.from_params(convert.params_from_numpy(**raw, device=dev), cap)
        st = S.prune_mask(st, kill.to(dev))
        new = {f: t.detach() * 2.0 for f, t in st.params.fields().items()}
        out.append(D._place_rows(st, new, prio.to(dev),
                                 want.to(dev) & st.live, budget))
    (sk, ck, pk, dk), (sp, cp, pp, dp) = out
    assert torch.equal(pk.cpu(), pp) and int(dk) == int(dp)
    assert torch.equal(ck.cpu()[pp], cp[pp])
    assert torch.equal(sk.live.cpu(), sp.live)
    for f in G.FIELDS:
        assert torch.equal(getattr(sk.params, f).cpu(),
                           getattr(sp.params, f)), f
        assert torch.equal(sk.opt.mu[f].cpu(), sp.opt.mu[f]), f


def test_scratch_step_offset_gradient_matches_cpu(cuda):
    """One scratch step on the card against the CPU plain path at
    train_vs_cpu's shape: loss within 1e-5 relative; the offset gradient
    (through the DensifyStats it feeds) and the first moments within
    chip_smoke.py's gradient tolerance (scaled, rtol 2e-3, atol 2e-4)."""
    from fovsplat_torch.models import densify as D
    from fovsplat_torch.train import scratch
    raw = proxy.train_arrays(proxy.bicycle_proxy(n=N, seed=1))
    gt = np.random.default_rng(1).uniform(0, 1, (H, W, 3)).astype(
        np.float32)
    out = []
    for dev in (cuda, torch.device("cpu")):
        st = S.from_params(convert.params_from_numpy(**raw, device=dev),
                           int(N * 1.3))
        cam = proxy.proxy_camera(W, H, device=dev)
        step = scratch.make_scratch_step(
            loops.LoopConfig(raster=RasterizeConfig(pair_capacity=1 << 20)),
            device=dev)
        new, ds, aux = step(st, D.init_stats(st.capacity, dev), cam,
                            torch.from_numpy(gt).to(dev), 1, 3)
        assert int(aux["overflow"]) == 0 and int(aux["nonfinite"]) == 0
        out.append((float(aux["loss"]), ds.grad_accum.cpu(), ds.denom.cpu(),
                    {f: v.cpu() for f, v in new.opt.mu.items()}))
    (lk, gk, dk, mk), (lp, gp, dp, mp) = out
    assert abs(lk - lp) <= 1e-5 * abs(lp)
    assert torch.equal(dk, dp) and float(dp.max()) == 1.0
    for a, b in [(gk, gp)] + [(mk[f], mp[f]) for f in mp]:
        scale = float(b.abs().max())
        assert scale > 0
        np.testing.assert_allclose(a.numpy() / scale, b.numpy() / scale,
                                   rtol=2e-3, atol=2e-4)


def test_lpips_matches_cpu_without_tf32(cuda, tmp_path):
    """LPIPS on chip_smoke.py's synthetic weights: the card within 1e-5
    relative of the CPU, two calls bit-identical, with TF32 allowed
    globally (the module's local cuDNN flag must keep it off)."""
    import chip_smoke
    from fovsplat_torch.eval import lpips_torch
    path = str(tmp_path / "vgg.npz")
    np.savez(path, **chip_smoke.synthetic_vgg_weights())
    net = lpips_torch.LPIPS(path)
    rng = np.random.default_rng(8)
    a = rng.uniform(0, 1, (H // 2, W // 2, 3)).astype(np.float32)
    b = np.clip(a + 0.1 * rng.normal(0, 1, a.shape), 0, 1).astype(np.float32)
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        ta, tb = torch.from_numpy(a).to(cuda), torch.from_numpy(b).to(cuda)
        first, second = net(ta, tb), net(ta, tb)
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    cpu = float(net(torch.from_numpy(a), torch.from_numpy(b)))
    assert torch.equal(first, second)
    assert abs(float(first) - cpu) <= 1e-5 * abs(cpu)


@pytest.mark.parametrize("gaze", [(0.5, 0.5), (0.2, 0.8)])
def test_foveated_hvs_matches_cpu(cuda, gaze):
    """metameric_loss_fov and blur_loss on the card within 1e-5 relative of
    the CPU; gen_metamer with one injected noise draw within 1e-5 of the
    image's range."""
    from fovsplat_torch.perception import foveated_loss as fl
    from fovsplat_torch.perception import metameric
    rng = np.random.default_rng(9)
    a = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    b = np.clip(a + 0.1 * rng.normal(0, 1, a.shape), 0, 1).astype(np.float32)
    noise = torch.rand((1, H, W, 3),
                       generator=torch.Generator().manual_seed(5))
    out = []
    for d in (cuda, torch.device("cpu")):
        x, y = torch.from_numpy(a).to(d), torch.from_numpy(b).to(d)
        with torch.no_grad():
            out.append((float(fl.metameric_loss_fov(x, y, gaze=gaze)),
                        float(metameric.blur_loss(x, y, gaze=gaze)),
                        metameric.gen_metamer(x, 2.0,
                                              noise=noise.to(d)).cpu()))
    (fk, bk, mk), (fp, bp, mp) = out
    assert abs(fk - fp) <= 1e-5 * abs(fp) and fp > 0
    assert abs(bk - bp) <= 1e-5 * abs(bp) and bp > 0
    assert float((mk - mp).abs().max()) <= 1e-5 * float(mp.max() - mp.min())


def test_rasterize_fov_matches_cpu_and_counts_launches(cuda):
    """The unpacked foveated render on the card against the CPU (within
    T_EPS), bit-identical twice; kernels 2 and 3 launch once a frame and
    kernel 1 never."""
    sc = proxy.bicycle_proxy(n=N, seed=2)
    keys = ("means", "scales", "rotations", "opacities4", "shs_dcs",
            "shs_rest", "highest_levels")
    cfg = RasterizeConfig(pair_capacity=1 << 20, sort_exact_depth=True)
    outs = []
    for d in (cuda, torch.device("cpu")):
        args = [torch.as_tensor(sc[k], device=d) for k in keys]
        cam = proxy.proxy_camera(W, H, device=d)
        gaze = torch.tensor((0.3, 0.6), device=d)
        for kf in (bt.build_table, ef.expand_fov, bf.blend_fov):
            kf.launches = 0
        o = fov.rasterize_fov(*args, cam, gaze, 0.05, bg_color=[0.1, 0.2, 0.3],
                              config=cfg)
        if d.type == "cuda":
            assert (bt.build_table.launches, ef.expand_fov.launches,
                    bf.blend_fov.launches) == (0, 1, 1)
            again = fov.rasterize_fov(*args, cam, gaze, 0.05,
                                      bg_color=[0.1, 0.2, 0.3], config=cfg)
            assert torch.equal(o["render"], again["render"])
        assert int(o["overflow"]) == 0
        outs.append((o["render"].cpu(), int(o["num_pairs"])))
    assert outs[0][1] == outs[1][1] > 1000
    assert float((outs[0][0] - outs[1][0]).abs().max()) <= 1e-4


def test_vq_compress_matches_cpu_and_repeats(cuda):
    """compress at 5,000 rows, codebook 256, with one set of draws: the
    card's dict equals the CPU's key for key, and a second card run
    equals the first (TF32 allowed globally: only vq's local flag keeps
    it off)."""
    from fovsplat_torch.models import vq
    from fovsplat_torch.models.gaussians import FIELDS, GaussianParams
    raw = proxy.train_arrays(proxy.bicycle_proxy(n=5_000, seed=3))
    imp = np.random.default_rng(4).random(5_000)
    n_vq = 5_000 - int(5_000 * 0.4)
    init, starts = vq.draws(n_vq, 256, 10, 80_000,
                            torch.Generator().manual_seed(2))
    comps = []
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        for d in (cuda, cuda, torch.device("cpu")):
            p = convert.params_from_numpy(**raw, device=d)
            comps.append(vq.compress(p, imp, 0.6, 256, 10, init, starts))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    for c in comps[1:]:
        assert sorted(c) == sorted(comps[0])
        for k in c:
            np.testing.assert_array_equal(c[k], comps[0][k], err_msg=k)
    dec = vq.decompress(comps[0], cuda)
    assert all(getattr(dec, f).device.type == cuda.type for f in FIELDS)
    assert isinstance(dec, GaussianParams)


def test_xla_route_launches_no_kernel_and_matches_the_kernels(cuda):
    """rasterize(backend="xla") on the card: no kernel launches, kept
    pairs equal to the kernel route's, images within T_EPS, gradients
    within 1e-4 of each input's largest and bit-identical twice."""
    sc = proxy.bicycle_proxy(n=N, seed=4)
    cam = proxy.proxy_camera(W, H, device=cuda)
    cols = torch.clamp(sh.SH_C0 * torch.as_tensor(
        sc["shs_dcs"][:, 0], device=cuda) + 0.5, min=0.0)
    arrs = [torch.as_tensor(sc[k], device=cuda)
            for k in ("means", "scales", "rotations")] + [
        torch.as_tensor(sc["opacities4"][:, 0], device=cuda), cols]
    wrappers = (ep1.expand_ps1, bfw.blend_forward, bfw.blend_backward,
                sr.reduce_by_sorted_gid, bs.blend_stats, bt.build_table,
                ef.expand_fov, bf.blend_fov)

    def run(backend):
        ins = [a.clone().requires_grad_(True) for a in arrs]
        out = rast.rasterize(*ins[:4], cam, colors=ins[4],
                             config=RasterizeConfig(pair_capacity=1 << 20,
                                                    backend=backend))
        (out["render"].square().sum() + out["final_T"].sum()).backward()
        return out, [x.grad for x in ins]
    kern, kg = run("kernels")
    for w in wrappers:
        w.launches = 0
    xa, xg = run("xla")
    xb, xg2 = run("xla")
    assert all(w.launches == 0 for w in wrappers)
    assert int(xa["binned"].num_pairs) == int(kern["binned"].num_pairs)
    err = (xa["render"] - kern["render"]).detach().abs().max()
    assert float(err) <= 1e-4
    for a, b, c in zip(xg, kg, xg2):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
        assert torch.equal(a, c)


@pytest.mark.parametrize("tile0", [1, 13])
def test_blend_fov_tile_range_matches_plain_and_whole_grid(cuda, tile0):
    """Kernel 3 over a tile range (tile0 > 0, as a tile-sharded owner
    launches it) against blend_fov_plain with the same tile0 within
    T_EPS, and bit-identical to the same tiles of the whole-grid launch."""
    gaze = (0.5, 0.5)
    model, cam, levels, bbox = _scene(cuda, gaze)
    gx, T = (W + 15) // 16, ((W + 15) // 16) * ((H + 15) // 16)
    tk, ck, _ = bt.build_table(model, cam, bbox)
    ek = ef.expand_fov(tk, ck, levels, 4, gx, 1 << 20, 1 << 20)
    key, dbits = fov.fused_key32(ek.tile, ek.depth, ek.kept[0], T)
    pairs, seg = fov.sort_pairs(key, dbits, ek.attrs, T, True)
    gxl, gyl, _, tb = foveation.compute_tile_level_infos(levels, W, H)
    _, l1, l2 = fov.chain_masks(levels, gxl, gyl, tb)
    n = T // 3
    args = (pairs, seg[tile0:tile0 + n + 1].contiguous(),
            l1[tile0:tile0 + n].contiguous(),
            l2[tile0:tile0 + n].contiguous(), gx)
    part = bf.blend_fov(*args, tile0=tile0)
    plain = bf.blend_fov_plain(*args, tile0=tile0)
    whole = bf.blend_fov(pairs, seg, l1, l2, gx)
    for a, b, c in zip(part, plain, whole):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4)
        assert torch.equal(a, c[tile0:tile0 + n])


def test_world_size_one_nccl_shards_match_single_device(cuda):
    """A world-size-1 NCCL group on the card: the tile-sharded frame
    ("kernels") and the foveated tile-sharded frame bit-identical to the
    single-device frames with the same rows and order."""
    import torch.distributed as dist
    from fovsplat_torch.parallel import dryrun, fov_shard, multihost
    from fovsplat_torch.parallel import tile_shard
    multihost.init_group(f"127.0.0.1:{dryrun.free_port()}", 1, 0, cuda,
                         "nccl")
    try:
        model, cam, _, _ = _scene(cuda, (0.5, 0.5))
        cfg = RasterizeConfig(pair_capacity=1 << 20, sort_exact_depth=True)
        g = torch.tensor((0.2, 0.8), device=cuda)
        img, aux = fov_shard.render_fov_tile_sharded(
            fov_shard.shard_fov_model(model), cam, g, 0.05, bg_color=[0.1,
                                                                      0.2,
                                                                      0.3],
            config=cfg)
        ref = fov.rasterize_fov_soa(model, cam, g, 0.05,
                                    bg_color=[0.1, 0.2, 0.3], config=cfg)
        assert torch.equal(img, ref["render"])
        assert int(aux["num_pairs"]) == int(ref["num_pairs"])
        assert int(aux["overflow"]) == 0
        sc = proxy.bicycle_proxy(n=N, seed=2)
        cols = torch.clamp(sh.SH_C0 * torch.as_tensor(
            sc["shs_dcs"][:, 0], device=cuda) + 0.5, min=0.0)
        arrs = [torch.as_tensor(sc[k], device=cuda)
                for k in ("means", "scales", "rotations", "opacity")]
        img, aux = tile_shard.render_tile_sharded(
            *arrs, cols, cam, pair_capacity=1 << 20, bg_color=[0.1, 0.2,
                                                               0.3])
        ref = rast.rasterize(*arrs, cam, colors=cols,
                             bg_color=[0.1, 0.2, 0.3],
                             config=RasterizeConfig(pair_capacity=1 << 20,
                                                    fwd_only=True,
                                                    sort_exact_depth=True))
        assert torch.equal(img, ref["render"])
        assert int(aux["num_pairs"]) == int(ref["binned"].num_pairs)
        assert int(aux["overflow"]) == 0
    finally:
        dist.destroy_process_group()


# CUDA graphs of the frames and the photometric step (utils/graphs)
# against their eager functions: the same kernels in the same order on
# the same inputs, so bit for bit.

GRAPH_PATHS = ["ours", "naive", "ps1", "ps1_compact", "mmfr"]


def _graphed_frame(dev, path):
    from fovsplat_torch.eval import fps
    from fovsplat_torch.utils import graphs
    cfg = RasterizeConfig(pair_capacity=1 << 20,
                          compact_table=path == "ps1_compact")
    if path.startswith("ps1"):
        model = _ps1_model(dev)
        return graphs.graphed_frame(
            lambda c, _gaze: rast.rasterize_ps1_soa(model, c, config=cfg))
    if path == "mmfr":
        return fps.make_mmfr_render(_mmfr_sh_models(dev), cfg)
    sc = proxy.bicycle_proxy(n=N, seed=2)
    return fps.make_fov_render(convert.fov_model_from_numpy(
        sc["means"], sc["scales"], sc["rotations"], sc["opacities4"],
        sc["shs_dcs"], sc["shs_rest"], sc["highest_levels"], device=dev,
        shared_colors=path == "naive"), cfg, mode=path)


def _set_counters(value=0):
    from fovsplat_torch.ops.kernels import launch_counters
    counters = launch_counters()
    for obj, attr in counters.values():
        setattr(obj, attr, value)
    return counters


@pytest.mark.parametrize("path", GRAPH_PATHS)
def test_graphed_frames_match_eager(cuda, path):
    """The graphed "ours", SM-FR, PS1 (compaction off and on) and MM-FR
    frames against their eager functions at two gazes: image, num_pairs
    and overflow bit for bit, one capture, and the first frame unchanged
    by the second (fresh outputs)."""
    frame = _graphed_frame(cuda, path)
    cam = proxy.proxy_camera(W, H, device=cuda)
    outs = []
    for gz in ((0.4, 0.6), (0.2, 0.2)):
        g = torch.tensor(gz, device=cuda)
        a, b = frame(cam, g), frame.eager(cam, g)
        for k in ("render", "num_pairs", "overflow"):
            assert torch.equal(a[k], b[k]), (gz, k)
        outs.append((a, b))
    (first, first_eager), (second, _) = outs
    assert torch.equal(first["render"], first_eager["render"])
    assert first["render"].data_ptr() != second["render"].data_ptr()
    assert frame.graph.captures == 1 and int(first["overflow"]) == 0
    if not path.startswith("ps1"):   # the PS1 frame has no gaze
        assert not torch.equal(first["render"], second["render"])


@pytest.mark.parametrize("path", ["ours", "ps1_compact", "mmfr"])
def test_launch_counters_count_replays(cuda, path):
    """After the capture, every launch counter moves by N times the
    graph's captured launches over N replays, and the capture itself
    counts only its warm-up's launches."""
    from fovsplat_torch.utils import graphs
    frame = _graphed_frame(cuda, path)
    cam = proxy.proxy_camera(W, H, device=cuda)
    g = torch.tensor((0.5, 0.5), device=cuda)
    counters = _set_counters()
    frame(cam, g)
    per = frame.graph.launches_per_replay
    assert per and all(v > 0 for v in per.values())
    first = {k: getattr(o, a) for k, (o, a) in counters.items()}
    assert first == {k: (graphs.WARMUPS + 1) * per.get(k, 0)
                     for k in counters}
    _set_counters()
    for _ in range(4):
        frame(cam, g)
    assert {k: getattr(o, a) for k, (o, a) in counters.items()} == {
        k: 4 * per.get(k, 0) for k in counters}
    want = {"ours": {"build_table", "expand_fov", "blend_fov"},
            "ps1_compact": {"build_table_ps1", "compact_table",
                            "expand_ps1", "blend_forward_q"},
            "mmfr": {"build_table_ps1", "expand_ps1",
                     "blend_forward_q"}}[path]
    assert set(per) == want


def test_graph_recaptures_on_a_new_camera_shape(cuda):
    """A camera of another shape is a new key: the graph is captured
    again (the old one is dropped) and still matches the eager frame."""
    frame = _graphed_frame(cuda, "ours")
    g = torch.tensor((0.5, 0.5), device=cuda)
    for w, h in ((W, H), (160, 112), (W, H)):
        cam = proxy.proxy_camera(w, h, device=cuda)
        out = frame(cam, g)
        assert tuple(out["render"].shape) == (h, w, 3)
        assert torch.equal(out["render"], frame.eager(cam, g)["render"])
    assert frame.graph.captures == 3


def test_graphed_steps_match_eager_across_scale_weight(cuda):
    """Three graphed photometric steps with the scale-decay term against
    three eager ones (loops.photometric_step), `it` 1-3 and scale_weight
    changed between them: loss, aux, every parameter and moment bit for
    bit; no step writes into a state returned before it or given to it;
    the kernels' counters move by the graph's launches per replay."""
    n, w, h = 5000, 160, 112
    gt = torch.from_numpy(np.random.default_rng(1).uniform(
        0, 1, (h, w, 3)).astype(np.float32)).to(cuda)
    cfg = loops.LoopConfig(raster=RasterizeConfig(pair_capacity=1 << 20))
    cam = proxy.proxy_camera(w, h, device=cuda)
    st = _train_state(cuda, n, 3)
    step = loops.make_photometric_step(cfg, use_scale_decay=True)

    def flat(s, aux=None):
        return ([getattr(s.params, f).detach() for f in s.params.fields()]
                + list(s.opt.mu.values()) + list(s.opt.nu.values())
                + [s.opt.count, s.live]
                + [aux[k] for k in sorted(aux or {})])
    st_kept = [t.clone() for t in flat(st)]
    se = sg = st
    graphed = []
    for it, sw in ((1, 2e-6), (2, 1e-4), (3, 0.0)):
        se, ae = loops.photometric_step(se, cam, gt, it, sw, cfg, True)
        sg, ag = step(sg, cam, gt, it, sw)
        fe, fg = flat(se, ae), flat(sg, ag)
        assert all(torch.equal(a, b) for a, b in zip(fe, fg)), it
        graphed.append(([t.clone() for t in fg], fg))
        assert int(ag["overflow"]) == 0 and int(ag["nonfinite"]) == 0
    for kept, live in graphed:
        assert all(torch.equal(a, b) for a, b in zip(kept, live))
    assert all(torch.equal(a, b) for a, b in zip(st_kept, flat(st)))
    assert step.graph.captures == 1
    counters = _set_counters()
    step(st, cam, gt, 4, 1e-4)
    per = step.graph.launches_per_replay
    assert {"expand_ps1", "blend_forward", "blend_backward",
            "reduce_by_sorted_gid"} <= set(per)
    assert {k: getattr(o, a) for k, (o, a) in counters.items()} == {
        k: per.get(k, 0) for k in counters}


# CUDA graphs of the HVS step, the eval, HVS, score and significance views
# and the scratch step against their eager functions, bit for bit.

def _small_graph_inputs(dev, n=5000, w=160, h=112, capacity=None):
    raw = proxy.train_arrays(proxy.bicycle_proxy(n=n, seed=3))
    st = S.from_params(convert.params_from_numpy(**raw, device=dev),
                       capacity or n + 64)
    gt = torch.from_numpy(np.random.default_rng(1).uniform(
        0, 1, (h, w, 3)).astype(np.float32)).to(dev)
    cfg = loops.LoopConfig(raster=RasterizeConfig(pair_capacity=1 << 20))
    return st, proxy.proxy_camera(w, h, device=dev), gt, cfg


def _flat_state(s, aux=None):
    return ([getattr(s.params, f).detach() for f in s.params.fields()]
            + list(s.opt.mu.values()) + list(s.opt.nu.values())
            + [s.opt.count] + [aux[k] for k in sorted(aux or {})])


@pytest.mark.parametrize("masking", [True, False])
def test_graphed_hvs_step_matches_eager(cuda, masking):
    """Three graphed HVS steps at pooling 3 against three eager ones
    (loops.hvs_step), `it` 1-3: loss, aux, every parameter and moment bit
    for bit; with masking the frozen fields equal the given ones in fresh
    tensors; no step changes a state given to or returned before it; one
    capture, and the counters move by the graph's launches a replay."""
    st, cam, gt, cfg = _small_graph_inputs(cuda)
    step = loops.make_hvs_step(cfg, 3.0, masking=masking)
    kept = [t.clone() for t in _flat_state(st)]
    se = sg = st
    outs = []
    for it in (1, 2, 3):
        se, ae = loops.hvs_step(se, cam, gt, it, cfg, 3.0, "L1", masking)
        sg, ag = step(sg, cam, gt, it)
        fe, fg = _flat_state(se, ae), _flat_state(sg, ag)
        assert all(torch.equal(a, b) for a, b in zip(fe, fg)), it
        outs.append(([t.clone() for t in fg], fg))
        assert int(ag["overflow"]) == 0 and int(ag["nonfinite"]) == 0
    for k, live in outs:
        assert all(torch.equal(a, b) for a, b in zip(k, live))
    assert all(torch.equal(a, b) for a, b in zip(kept, _flat_state(st)))
    if masking:
        for f in ("xyz", "features_rest", "scaling", "rotation"):
            assert torch.equal(getattr(sg.params, f), getattr(st.params, f))
            assert getattr(sg.params, f).data_ptr() != getattr(
                st.params, f).data_ptr()
    assert step.graph.captures == 1
    counters = _set_counters()
    step(st, cam, gt, 4)
    per = step.graph.launches_per_replay
    assert {"expand_ps1", "blend_forward", "blend_backward",
            "reduce_by_sorted_gid"} <= set(per)
    assert {k: getattr(o, a) for k, (o, a) in counters.items()} == {
        k: per.get(k, 0) for k in counters}


VIEW_PATHS = ["eval_view", "hvs_view", "score_max_comp_efficiency",
              "score_max_contrib", "score_surface", "significance"]


def _view_fn(path, cfg):
    from fovsplat_torch.train import scratch
    if path == "eval_view":
        return loops.make_eval_fns(cfg)[0], ()
    if path == "hvs_view":
        return loops.make_eval_fns(cfg)[1], (3.0,)
    if path == "significance":
        return scratch.make_significance_view(cfg), ()
    return loops.make_score_fn(cfg, path[len("score_"):]), ()


def _leaves(out):
    if isinstance(out, dict):
        return [out[k] for k in sorted(out)]
    return list(out) if isinstance(out, tuple) else [out]


@pytest.mark.parametrize("path", VIEW_PATHS)
def test_graphed_views_match_eager(cuda, path):
    """The graphed eval, HVS (pooling 3), score (three metrics) and
    significance views against their eager functions on two states (the
    second with a third of the rows dead): bit for bit, one capture, the
    first output unchanged by the second call, the counters moved by the
    graph's launches a replay (kernel 8 on the score and significance
    views)."""
    st, cam, gt, cfg = _small_graph_inputs(cuda)
    fn, static = _view_fn(path, cfg)
    args = (gt,) if path in ("eval_view", "hvs_view") else ()
    cut = S.prune_mask(st, torch.arange(st.capacity, device=cuda) % 3 == 0)
    first = [t.clone() for t in _leaves(fn(st, cam, *args, *static))]
    for s in (st, cut):
        a = _leaves(fn(s, cam, *args, *static))
        b = _leaves(fn.eager(s, cam, *args, *static))
        assert len(a) == len(b) and all(torch.equal(x, y)
                                        for x, y in zip(a, b))
    assert not all(torch.equal(x, y) for x, y in zip(first, a))
    again = _leaves(fn(st, cam, *args, *static))
    assert all(torch.equal(x, y) for x, y in zip(first, again))
    assert fn.graph.captures == 1
    counters = _set_counters()
    fn(st, cam, *args, *static)
    per = fn.graph.launches_per_replay
    if path.startswith("score") or path == "significance":
        assert {"expand_ps1", "blend_stats"} <= set(per)
    assert {k: getattr(o, a) for k, (o, a) in counters.items()} == {
        k: per.get(k, 0) for k in counters}


def test_hvs_view_recaptures_on_a_pooling_change(cuda):
    """The pooling size is part of hvs_view's key (it fixes the pooling's
    shapes): pooling 3, 7, 7, 3 capture three times and each call matches
    the eager view; `float(pooling)` and the int give the same key."""
    st, cam, gt, cfg = _small_graph_inputs(cuda)
    _, hvs_view = loops.make_eval_fns(cfg)
    for ps in (3, 7.0, 7, 3.0):
        assert torch.equal(hvs_view(st, cam, gt, ps),
                           hvs_view.eager(st, cam, gt, ps)), ps
    assert hvs_view.graph.captures == 3


# Kernels 11-12b, the uniform HVS loss, against their twin: the torch code
# of perception/metameric.py, run on the card.

def _hvs_images(dev, h, w, seed):
    """A seeded noise image and a target 0.1 of noise away from it."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    b = np.clip(a + 0.1 * rng.normal(0, 1, a.shape), 0, 1).astype(np.float32)
    return torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)


def _hvs_loss_and_grad(fn, x):
    xl = x.clone().requires_grad_(True)
    loss = fn(xl)
    return loss.detach(), torch.autograd.grad(loss, xl)[0]


def _check_hvs_kernels(dev, h, w, pooling, loss_type):
    """Kernel 11's grids of image and target each within 1e-5 of the
    grid's largest value; the loss (11b) within 1e-5 relative; the image
    gradient (12, 12b) each channel within 1e-5 of its largest value, of
    the twin's gradient (MSE) and of the twin's gradient at the kernels'
    forward values (L1 and MSE): its grids carried to the kernel's
    straight through, so that each |gap| takes the kernel's sign (with
    L1 a gap within rounding of 0 can take the other sign in the twin's
    own forward, which moves the gradient by ~1e-3 of its largest value
    at this width); two calls bit-identical."""
    x, t = _hvs_images(dev, h, w, 7)
    metameric.prepare(h, w, pooling, device=dev)
    p = hvs.plan(h, w, pooling, 5, str(x.device))
    pyr = hvs.hvs_level_forward(x[None], t[None], p)
    for k, img in enumerate((x, t)):
        ref, _ = hvs.pooled_grids_plain(img, pooling)
        got = hvs.kernel_grids(pyr, k, 1)
        assert len(got) == len(ref) == 25
        for i, (pair, ref_pair) in enumerate(zip(got, ref)):
            for a, b in zip(pair, ref_pair):
                assert a.shape == b.shape, (k, i)
                err = float((a - b).abs().max())
                assert err <= 1e-5 * float(b.abs().max()), (k, i, err)
    ref_loss, ref_grad = _hvs_loss_and_grad(
        lambda xl: metameric.metameric_loss_uniform(
            metameric.resize_for_pyramid(xl), metameric.resize_for_pyramid(t),
            pooling, loss_type=loss_type), x)
    got = [_hvs_loss_and_grad(lambda xl: hvs.uniform_loss(
        xl, t, pooling, loss_type=loss_type), x) for _ in range(2)]
    assert torch.equal(got[0][0], got[1][0])
    assert torch.equal(got[0][1], got[1][1])
    loss, grad = got[0]
    torch.testing.assert_close(loss, ref_loss, rtol=1e-5, atol=0)
    assert grad.shape == ref_grad.shape == (h, w, 3)

    kx, kt = hvs.kernel_grids(pyr, 0, 1), hvs.kernel_grids(pyr, 1, 1)
    maps_t = hvs.maps_from_grids_plain(
        kt, hvs.pooled_grids_plain(t, pooling)[1], pooling, h, w)

    def at_kernel_grids(xl):
        gx, last = hvs.pooled_grids_plain(xl, pooling)
        gx = [tuple(a + (k - a).detach() for a, k in zip(pair, kpair))
              for pair, kpair in zip(gx, kx)]
        return metameric.loss_from_stats(
            hvs.maps_from_grids_plain(gx, last, pooling, h, w), maps_t,
            loss_type)
    refs = [_hvs_loss_and_grad(at_kernel_grids, x)[1]]
    if loss_type == "MSE":
        refs.append(ref_grad)
    for ref in refs:
        scale = ref.abs().amax(dim=(0, 1))
        err = (grad - ref).abs().amax(dim=(0, 1))
        assert bool((err <= 1e-5 * scale).all()), (err / scale).tolist()


@pytest.mark.parametrize("loss_type", ["L1", "MSE"])
@pytest.mark.parametrize("pooling", [3.0, 5.5])
def test_hvs_kernels_match_twin(cuda, pooling, loss_type):
    """Kernels 11-12b at the cell's 1237x822 (resized to 1248x832), at
    pooling 3 (levels 2 and 3 pool up onto a larger grid) and 5.5 (the
    area bins overlap)."""
    _check_hvs_kernels(cuda, 822, 1237, pooling, loss_type)


@pytest.mark.parametrize("h, w, pooling", [(96, 160, 1.0), (90, 150, 12.0),
                                           (64, 64, 2.0)])
def test_hvs_kernels_match_twin_small(cuda, h, w, pooling):
    """The same at small sizes: a multiple of 32 (no resize) at pooling 1
    (level 0 unpooled, the rest pooled up), bins larger than a block's
    pixel chunk at pooling 12, and level 1 unpooled at pooling 2."""
    for loss_type in ("L1", "MSE"):
        _check_hvs_kernels(cuda, h, w, pooling, loss_type)


def test_graphed_hvs_step_launches_hvs_kernels(cuda):
    """A graphed HVS step launches kernels 11-12b in its replays: four band
    levels forward and back, the two passes of 11b, and at level 0 the
    image side and the resize's transpose (112 rows are resized)."""
    st, cam, gt, cfg = _small_graph_inputs(cuda)
    step = loops.make_hvs_step(cfg, 3.0, masking=True)
    step(st, cam, gt, 1)
    per = step.graph.launches_per_replay
    assert {k: per.get(k, 0) for k in (
        "hvs_level_forward", "hvs_stats_loss", "hvs_stats_backward",
        "hvs_level_backward")} == {
        "hvs_level_forward": 4, "hvs_stats_loss": 2,
        "hvs_stats_backward": 4, "hvs_level_backward": 6}


# Kernels 13 and 13b (ops/kernels/ssim.py) against the twin, losses.
# ssim_plain, run on the card.

SSIM_SHAPES = [(822, 1237), (37, 53)]


def _ssim_images(dev, batch, h, w, flat=True):
    """Seeded noise and a target 0.1 of noise away, clipped to [0, 1];
    with `flat`, a black corner and a white one in both and a 20 x 30
    region at 0.3 in both (larger than the window)."""
    rng = np.random.default_rng(batch * 1000 + h)
    shape = (batch, h, w, 3)
    a = rng.uniform(0, 1, shape).astype(np.float32)
    b = np.clip(a + 0.1 * rng.normal(0, 1, shape), 0, 1).astype(np.float32)
    if flat:
        a[:, :5, :7] = b[:, :5, :7] = 0.0
        a[:, -4:, -6:] = b[:, -4:, -6:] = 1.0
        a[:, 8:28, 10:40] = b[:, 8:28, 10:40] = 0.3
    return torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("h, w", SSIM_SHAPES)
@pytest.mark.parametrize("robust", [False, True])
def test_ssim_forward_matches_plain(cuda, robust, h, w, batch):
    """Kernel 13's mean within 1e-5 relative of the twin on the card (flat
    regions, values at 0 and 1, ragged tiles at 37 x 53), bit-identical
    twice; losses.ssim on the card is kernel 13, one call a call."""
    from fovsplat_torch.ops.kernels import ssim as sk
    from fovsplat_torch.train import losses
    a, b = _ssim_images(cuda, batch, h, w)
    k = sk.ssim_forward(a, b, 1.5, robust)
    ref = losses.ssim_plain(a, b, robust=robust)
    assert float((k - ref).abs()) <= 1e-5 * float(ref.abs())
    assert torch.equal(k, sk.ssim_forward(a, b, 1.5, robust))
    before = sk.ssim_forward.launches
    routed = losses.ssim(a[0] if batch == 1 else a, b[0] if batch == 1
                         else b, robust=robust)
    assert torch.equal(routed, k) and sk.ssim_forward.launches == before + 1


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("h, w", SSIM_SHAPES)
@pytest.mark.parametrize("flat", [False, True])
def test_ssim_backward_matches_autograd(cuda, flat, h, w, batch):
    """Kernel 13b through losses.ssim's autograd against autograd of the
    twin on the card: the gradient of the image, and of the target where
    it requires one, within 1e-5 of each gradient's largest value on
    noise; on flat regions (a 20 x 30 patch at 0.3 in both, where the
    variances cancel in f32) no further from the twin's float64 gradient
    than twice the twin's own f32 autograd is. Bit-identical twice."""
    from fovsplat_torch.ops.kernels import ssim as sk
    from fovsplat_torch.train import losses
    a, b = _ssim_images(cuda, batch, h, w, flat)

    def grads(fn, x, y, target_grad):
        x = x.clone().requires_grad_(True)
        y = y.clone().requires_grad_(target_grad)
        leaves = [x, y] if target_grad else [x]
        return torch.autograd.grad(-0.2 * fn(x, y), leaves)
    for target_grad in (False, True):
        before = sk.ssim_backward.launches
        got = grads(losses.ssim, a, b, target_grad)
        assert sk.ssim_backward.launches == before + 1
        again = grads(losses.ssim, a, b, target_grad)
        assert all(torch.equal(p, q) for p, q in zip(got, again))
        ref = grads(losses.ssim_plain, a, b, target_grad)
        exact = grads(losses.ssim_plain, a.double(), b.double(), target_grad)
        for g, r, x in zip(got, ref, exact):
            scale = float(x.abs().max())
            err = float((g.double() - x).abs().max()) / scale
            if flat:
                twin = float((r.double() - x).abs().max()) / scale
                assert err <= 2 * twin, (err, twin)
            else:
                assert float((g - r).abs().max()) <= 1e-5 * float(
                    r.abs().max())


def test_photometric_step_launches_ssim_kernels_once(cuda):
    """A graphed photometric step holds one call of kernel 13 and one of
    13b, and its replays add them to the counters."""
    from fovsplat_torch.ops.kernels import ssim as sk
    st, cam, gt, cfg = _small_graph_inputs(cuda)
    step = loops.make_photometric_step(cfg)
    step(st, cam, gt, 1)
    per = step.graph.launches_per_replay
    assert per.get("ssim_forward") == 1 and per.get("ssim_backward") == 1
    f, b = sk.ssim_forward.launches, sk.ssim_backward.launches
    step(st, cam, gt, 2)
    assert (sk.ssim_forward.launches, sk.ssim_backward.launches) == (f + 1,
                                                                     b + 1)


def test_graphed_scratch_step_across_sh_raise_and_densify(cuda):
    """Six graphed scratch steps against six eager ones (scratch_step),
    the SH degree raised from 0 to 1 after step 2 and a densify event
    (clone, split with one noise draw, size prune, fresh aliased
    statistics) after step 4: state, statistics and aux bit for bit;
    one capture a degree and none at the densify event (the capacity is
    fixed)."""
    from fovsplat_torch.models import densify as D
    from fovsplat_torch.train import scratch
    st, cam, gt, cfg = _small_graph_inputs(cuda, capacity=6000)
    step = scratch.make_scratch_step(cfg)
    de = dg = D.init_stats(st.capacity, cuda)
    se = sg = st
    noise = torch.randn((2, st.capacity, 3),
                        generator=torch.Generator(device=cuda).manual_seed(0),
                        device=cuda)
    captures = []
    for it in range(1, 7):
        sh = 0 if it <= 2 else 1
        se, de, ae = scratch.scratch_step(se, de, cam, gt, it, sh, cfg)
        sg, dg, ag = step(sg, dg, cam, gt, it, sh)
        fe = _flat_state(se, ae) + list(D.stats_tensors(de))
        fg = _flat_state(sg, ag) + list(D.stats_tensors(dg))
        assert all(torch.equal(a, b) for a, b in zip(fe, fg)), it
        assert torch.equal(se.live, sg.live)
        if it == 4:
            live_before = se.live.clone()
            outs = []
            for s, d in ((se, de), (sg, dg)):
                s, _ = D.densify_and_clone(s, d, 1e-7, 4.0, 0.01, 256)
                s, _ = D.densify_and_split(s, d, 1e-7, 4.0, 0.01, 256,
                                           noise=noise)
                outs.append((D.prune_oversized(s, d, None, 4.0),
                             D.init_stats(st.capacity, cuda)))
            (se, de), (sg, dg) = outs
            assert not torch.equal(se.live, live_before)
        captures.append(step.graph.captures)
    assert captures == [1, 1, 2, 2, 2, 2]


def test_graphed_scratch_step_captures_once_a_bucket(cuda, monkeypatch):
    """The published schedule's scratch steps (no densify budget, the
    statistics in NDC) graphed against eager ones across densify events
    with every candidate (train/scratch.densify_event, applied to each
    side's own state): state, statistics and aux bit for bit, also at the
    grown capacities; the capacity grown by the bucket rule, and exactly
    one capture a capacity (none at an event that fits)."""
    from fovsplat_torch.models import densify as D
    from fovsplat_torch.train import scratch
    st, cam, gt, cfg = _small_graph_inputs(cuda, capacity=5120)
    monkeypatch.setattr(scratch, "CAPACITY_QUANTUM", 1024)
    scfg = scratch.ScratchConfig(densify_budget=None)
    step = scratch.make_scratch_step(cfg, scfg=scfg)
    de = dg = D.init_stats(st.capacity, cuda)
    se = sg = st
    gen = torch.Generator(device=cuda).manual_seed(0)
    caps, captures = [], []
    for it in range(1, 10):
        se, de, ae = scratch.scratch_step(se, de, cam, gt, it, 1, cfg,
                                          scfg)
        sg, dg, ag = step(sg, dg, cam, gt, it, 1)
        fe = _flat_state(se, ae) + list(D.stats_tensors(de))
        fg = _flat_state(sg, ag) + list(D.stats_tensors(dg))
        assert all(torch.equal(a, b) for a, b in zip(fe, fg)), it
        assert torch.equal(se.live, sg.live)
        caps.append(se.capacity)
        captures.append(step.graph.captures)
        if it % 3 == 0:
            noise = torch.randn((2, se.capacity, 3), generator=gen,
                                device=cuda)
            need = int(se.live.sum())
            se, de, ev = scratch.densify_event(se, de, it, scfg, 4.0, noise)
            sg, dg, _ = scratch.densify_event(sg, dg, it, scfg, 4.0, noise)
            need += int(ev.cloned) + int(ev.split)
            assert int(ev.dropped) == 0 and int(ev.cloned) > 0
            if ev.capacity_after != ev.capacity_before:
                assert ev.capacity_after == scratch.capacity_bucket(need)
    assert len(set(caps)) >= 2
    assert captures == [len(set(caps[:i + 1])) for i in range(len(caps))]


def test_scratch_step_refuses_gid_row_bound_on_the_card(cuda):
    """The graphed scratch step refuses a kept capacity of 2^24 before it
    captures, as the score route refuses past its bound."""
    from fovsplat_torch.models import densify as D
    from fovsplat_torch.train import scratch
    st, cam, gt, cfg = _small_graph_inputs(cuda)
    cfg = dataclasses.replace(cfg, raster=dataclasses.replace(
        cfg.raster, compact_capacity=stats.GID_EXACT))
    step = scratch.make_scratch_step(cfg)
    with pytest.raises(ValueError, match="exact"):
        step(st, D.init_stats(st.capacity, cuda), cam, gt, 1, 1)
    assert step.graph.captures == 0


# CUDA graphs of the last jit sites: distill's teacher render, the
# quality and layer renders, SSIM and LPIPS, VQ's assignment and EMA
# update, the DP step on NCCL.

RENDER_PATHS = ["teacher", "ps1", "layer_ours", "layer_naive"]


def _graphed_render(path, st, cfg):
    from types import SimpleNamespace
    from fovsplat_torch.eval import layers, quality
    from fovsplat_torch.train import distill
    if path == "teacher":
        return distill.teacher_render(st, cfg)
    if path == "ps1":
        return quality.make_ps1_render(st, cfg.raster)
    rng = np.random.default_rng(8)
    n = st.capacity
    hl = rng.integers(0, 4, n)
    if path == "layer_naive":
        return layers.layer_render_naive(st.params, st.live, hl, 2,
                                         cfg.raster)
    comp = SimpleNamespace(
        highest_levels=hl,
        opacities=rng.uniform(0.2, 0.9, (n, 4)).astype(np.float32),
        shs_dcs=rng.normal(0, 0.5, (n, 4, 3)).astype(np.float32))
    return layers.layer_render_ours(st.params, st.live, comp, 2, cfg.raster)


@pytest.mark.parametrize("path", RENDER_PATHS)
def test_graphed_renders_match_eager(cuda, path):
    """distill's teacher render, the quality render and both layer
    renders as graphs against their eager functions on two cameras of one
    shape: bit for bit, fresh outputs, the camera tensors unchanged, one
    capture, and the counters moved by N times the graph's launches
    (kernels 4 and 5) over N replays."""
    from fovsplat_torch.data.cameras import camera_tensors
    st, cam, _, cfg = _small_graph_inputs(cuda)
    from fovsplat_torch.data.cameras import look_at_camera
    other = look_at_camera([3.0, -1.0, -2.6], [0.0, 0.0, 0.0], [0, -1, 0],
                           fovx=1.20, fovy=1.20 * cam.height / cam.width
                           * 1.24, width=cam.width, height=cam.height,
                           device=cuda)
    render = _graphed_render(path, st, cfg)
    kept = [t.clone() for t in camera_tensors(cam)]
    first = render(cam)
    first_copy = first.clone()
    second = render(other)
    assert torch.equal(first, render.eager(cam))
    assert torch.equal(second, render.eager(other))
    assert not torch.equal(first, second)
    assert torch.equal(first, first_copy)
    assert first.data_ptr() != second.data_ptr()
    assert all(torch.equal(a, b) for a, b in zip(kept, camera_tensors(cam)))
    assert render.graph.captures == 1
    counters = _set_counters()
    for _ in range(3):
        render(cam)
    per = render.graph.launches_per_replay
    assert {"expand_ps1", "blend_forward"} <= set(per)
    assert {k: getattr(o, a) for k, (o, a) in counters.items()} == {
        k: 3 * per.get(k, 0) for k in counters}


@pytest.mark.parametrize("name", ["ssim", "lpips"])
def test_graphed_metrics_match_eager(cuda, name, tmp_path):
    """The SSIM metric (losses.ssim) and LPIPS as graphs against their
    eager functions with TF32 allowed globally: bit for bit on two image
    pairs, fresh outputs, inputs unchanged, one capture a shape (a second
    shape captures again); no kernel counter moved but SSIM's kernel 13,
    once a call: three replays, a warm-up a capture, three eager calls."""
    from fovsplat_torch.eval import lpips_torch, metrics
    from fovsplat_torch.train import losses
    if name == "ssim":
        fn = metrics.graphs.graphed_fn(
            lambda a, b, size, robust: losses.ssim(a, b, size,
                                                   robust=robust), 2)
        static = (11, False)
    else:
        from chip_smoke import synthetic_vgg_weights
        path = tmp_path / "vgg.npz"
        np.savez(path, **synthetic_vgg_weights())
        fn, static = lpips_torch.LPIPS(str(path)), ()
    rng = np.random.default_rng(3)
    imgs = [torch.from_numpy(rng.uniform(0, 1, (H, W, 3)).astype(
        np.float32)).to(cuda) for _ in range(4)]
    kept = [t.clone() for t in imgs]
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    counters = _set_counters()
    try:
        a = fn(imgs[0], imgs[1], *static)
        b = fn(imgs[2], imgs[3], *static)
        assert torch.equal(a, fn.eager(imgs[0], imgs[1], *static))
        assert torch.equal(b, fn.eager(imgs[2], imgs[3], *static))
        assert a.data_ptr() != b.data_ptr() and not torch.equal(a, b)
        assert fn.graph.captures == 1
        small = [t[:56, :80] for t in imgs[:2]]
        assert torch.equal(fn(*small, *static), fn.eager(*small, *static))
        assert fn.graph.captures == 2
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
    assert all(torch.equal(x, y) for x, y in zip(kept, imgs))
    want = {k: 0 for k in counters}
    if name == "ssim":
        want["ssim_forward"] = 3 + 2 * metrics.graphs.WARMUPS + 3
    assert {k: getattr(o, at) for k, (o, at) in counters.items()} == want


def test_graphed_vq_matches_eager_and_cpu(cuda, monkeypatch):
    """compress at 20,000 rows, codebook 256 (chip_smoke's vs_cpu shape)
    with one set of draws: the graphed card run equals the eager card run
    (graphs.graphed_fn made the identity) and the CPU's key for key; one
    near-tie slot a chunk overflows, regrows (a recapture) and gives the
    same dict."""
    from fovsplat_torch.models import vq
    from fovsplat_torch.utils import graphs
    raw = proxy.train_arrays(proxy.bicycle_proxy(n=20_000, seed=3))
    imp = np.random.default_rng(4).random(20_000)
    n_vq = 20_000 - int(20_000 * 0.4)
    init, starts = vq.draws(n_vq, 256, 10, 80_000,
                            torch.Generator().manual_seed(2))

    def run(dev, ties=None):
        p = convert.params_from_numpy(**raw, device=dev)
        return vq.compress(p, imp, 0.6, 256, 10, init, starts, ties=ties)
    ties = vq.Ties()
    graphed = run(cuda, ties)
    one = vq.Ties(capacity=1)
    regrown = run(cuda, one)
    cpu = run("cpu")
    with monkeypatch.context() as m:
        m.setattr(graphs, "graphed_fn", lambda fn, n_static=0,
                  prepare=None: fn)
        eager = run(cuda)
    for c in (regrown, cpu, eager):
        assert sorted(c) == sorted(graphed)
        for k in c:
            np.testing.assert_array_equal(c[k], graphed[k], err_msg=k)
    assert ties.regrown == 0 and ties.most <= ties.capacity
    if one.most > 1:
        assert one.regrown >= 1 and one.capacity >= one.most


def test_graphed_dp_step_matches_eager_on_nccl(cuda):
    """The DP step as a graph on a world-size-1 NCCL group, three steps
    of one view from one state against the eager DP step and
    trainer.make_train_step(group=): parameters, moments, count and loss
    bit for bit, fresh outputs, the given state unchanged, one capture,
    and the counters moved by the graph's launches a replay."""
    import torch.distributed as dist
    from fovsplat_torch.parallel import data_parallel as dp
    from fovsplat_torch.parallel import dryrun, multihost
    from fovsplat_torch.train import optim, trainer
    multihost.init_group(f"127.0.0.1:{dryrun.free_port()}", 1, 0, cuda,
                         "nccl")
    try:
        st, cam, gt, _ = _small_graph_inputs(cuda)
        cfg = trainer.TrainConfig(raster=RasterizeConfig(
            pair_capacity=1 << 20))
        group = dp.make_mesh()
        step = dp.make_dp_train_step(cfg, group)
        one = trainer.make_train_step(cfg, group=group)
        cams = dp.stack_cameras([cam])
        p0, o0 = st.params, optim.init_state(st.params)
        kept = [getattr(p0, f).detach().clone() for f in p0.fields()]

        def flat(p, o, loss):
            return ([getattr(p, f).detach() for f in p.fields()]
                    + list(o.mu.values()) + list(o.nu.values())
                    + [o.count, loss])
        runs = {"graph": (p0, o0), "eager": (p0, o0), "one": (p0, o0)}
        outs = []
        for it in (1, 2, 3):
            p, o, aux = step(*runs["graph"], cams, gt[None], it)
            pe, oe, auxe = step.eager(*runs["eager"], cams, gt[None], it)
            p1, o1, aux1 = one(*runs["one"], cam, gt, it)
            fg, fe = flat(p, o, aux["loss"]), flat(pe, oe, auxe["loss"])
            f1 = flat(p1, o1, aux1["loss"])
            assert all(torch.equal(a, b) for a, b in zip(fg, fe)), it
            assert all(torch.equal(a, b) for a, b in zip(fg, f1)), it
            assert int(aux["overflow"]) == 0
            outs.append(([t.clone() for t in fg], fg))
            runs = {"graph": (p, o), "eager": (pe, oe), "one": (p1, o1)}
        for copy, live in outs:
            assert all(torch.equal(a, b) for a, b in zip(copy, live))
        assert all(torch.equal(a, getattr(p0, f))
                   for a, f in zip(kept, p0.fields()))
        assert step.graph.captures == 1
        counters = _set_counters()
        step(p0, o0, cams, gt[None], 1)
        per = step.graph.launches_per_replay
        assert {"expand_ps1", "blend_forward", "blend_backward",
                "reduce_by_sorted_gid"} <= set(per)
        assert {k: getattr(o_, a_) for k, (o_, a_) in counters.items()} == {
            k: per.get(k, 0) for k in counters}
    finally:
        dist.destroy_process_group()


# The stage map of a graph (utils/profiling): the device operations of
# three profiled replays matched to the stages their capture recorded.

def _own_kernel_names():
    import re
    from pathlib import Path
    import fovsplat_torch
    names = set()
    for src in (Path(fovsplat_torch.__file__).parent / "csrc").glob("*.cu*"):
        names.update(re.findall(
            r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(",
            src.read_text()))
    return re.compile(r"\b(%s)\s*[(<]" % "|".join(sorted(names)))


def _staged_call(dev, path):
    """(call(), its Graph) of the "ours" frame, the PS1 frame or a
    photometric step."""
    if path == "step":
        n, w, h = 5000, 160, 112
        gt = torch.from_numpy(np.random.default_rng(1).uniform(
            0, 1, (h, w, 3)).astype(np.float32)).to(dev)
        cfg = loops.LoopConfig(raster=RasterizeConfig(pair_capacity=1 << 20))
        cam = proxy.proxy_camera(w, h, device=dev)
        st = _train_state(dev, n, 3)
        step = loops.make_photometric_step(cfg)
        return (lambda: step(st, cam, gt, 1)), step.graph
    frame = _graphed_frame(dev, path)
    cam = proxy.proxy_camera(W, H, device=dev)
    g = torch.tensor((0.5, 0.5), device=dev)
    return (lambda: frame(cam, g)), frame.graph


class _CountedEntry:
    """A kernel library's entry point that, while its stream captures a
    graph, notes the kernel nodes each call added."""

    def __init__(self, fn, calls):
        object.__setattr__(self, "_fn", fn)
        object.__setattr__(self, "_calls", calls)

    def __setattr__(self, name, value):
        setattr(self._fn, name, value)

    def __call__(self, *args):
        from fovsplat_torch.utils import profiling
        if not torch.cuda.is_current_stream_capturing():
            return self._fn(*args)
        stream = torch.cuda.current_stream().cuda_stream
        before = profiling._read_nodes(stream, 0)[0]
        out = self._fn(*args)
        after = profiling._read_nodes(stream, 0)[0]
        if after > before:
            types = profiling._read_nodes(stream, after)[1]
            self._calls.append(sum(t == 0 for t in types[before:]))
        return out


class _CountedLib:
    def __init__(self, lib, calls):
        self._lib, self._calls = lib, calls

    def __getattr__(self, name):
        fn = getattr(self._lib, name)
        if name.startswith("fs_") and name != "fs_error_string":
            return _CountedEntry(fn, self._calls)
        return fn


@pytest.mark.parametrize("path", ["ours", "ps1", "step"])
def test_stage_map_splits_three_replays(cuda, path, monkeypatch):
    """Three profiled replays all match their capture's stage map; kernel
    3 lies in blend, kernel 6 in backward, the radix sort in a sort
    stage; the stages add up to the replay's device time within 1%; the
    kernel nodes that the entry calls of csrc/ libraries added during the
    capture are those the trace names after csrc/, and the calls that
    added them equal launches_per_replay."""
    from torch.profiler import ProfilerActivity, profile
    from fovsplat_torch.ops.kernels import _build
    from fovsplat_torch.utils import profiling
    call, graph = _staged_call(cuda, path)
    calls = []
    load = _build.load
    with monkeypatch.context() as m:
        m.setattr(_build, "load", lambda name: load(name) if name ==
                  "capture_nodes" else _CountedLib(load(name), calls))
        call()                                  # warm-up and capture
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            call()
        torch.cuda.synchronize()
    events = list(prof.events())
    report = profiling.window_report(events)
    rec = graph.record
    g = report["graphs"][str(rec.serial)]
    assert g["replays"] == 3 and g["unmatched"] == 0, report
    assert g["nodes"] == rec.nodes > 0
    per = graph.launches_per_replay
    assert len(calls) == sum(v for k, v in per.items()
                             if k != "blend_fov_tile0")
    own = _own_kernel_names()
    dev = sorted((e for e in events if e.device_type.name == "CUDA"
                  and not e.is_user_annotation),
                 key=lambda e: e.time_range.start)
    want = {"ours": ("blend", "blend_fov_kernel"),
            "ps1": ("blend", "blend_fwd_kernel"),
            "step": ("backward", "blend_bwd_kernel")}[path]
    for serial, ops in profiling.replay_stages(events):
        assert serial == str(rec.serial) and ops is not None
        labels = {}
        for label, e in ops:
            labels.setdefault(label, []).append(e.name)
        assert any(want[1] in n for n in labels[want[0]])
        assert any("RadixSort" in n for lb, names in labels.items()
                   if lb.split("/")[-1] == "sort" for n in names)
        assert sum(1 for _, e in ops if own.search(e.name)) == sum(calls)
        # Every device operation inside the replay's span of the device.
        t0 = min(e.time_range.start for _, e in ops)
        t1 = max(e.time_range.end for _, e in ops)
        inside = sum(e.time_range.end - e.time_range.start for e in dev
                     if t0 <= e.time_range.start < t1)
        mine = sum(e.time_range.end - e.time_range.start for _, e in ops)
        assert abs(inside - mine) <= 0.01 * inside
    assert abs(sum(g["stage_s"].values()) - g["device_s"]) <= \
        1e-9 + 1e-6 * g["device_s"]



def test_dense_score_pass_graphed_matches_eager(cuda):
    """The metric-prune score pass on the dense proxy (benchmark/
    reference/dense.py) cut to 1.5M rows at 1237x822, two ring views:
    the graphed pass equals the eager one bit for bit, its overflow
    included, at the configuration's capacities (no overflow) and at a
    pair capacity that spills (both count the same overflow); the cut
    kills 2% of the rows; and profiling.window_report splits a view's
    replay into the score route's stages with 0 unmatched operations and
    under 1% of its device time outside every span."""
    import json
    import types
    from pathlib import Path
    from torch.profiler import ProfilerActivity, profile
    from benchmark.reference import camera as refcam
    from benchmark.reference import dense
    from benchmark.runners.frame_loop import program_cameras
    from fovsplat_torch.models.gaussians import GaussianParams
    from fovsplat_torch.utils import profiling
    root = Path(__file__).resolve().parents[1]
    cfg = json.loads((root / "benchmark/configs/bicycle-3dgs-dense.json")
                     .read_text())
    fc = cfg["frame"]
    fc["points"] = 1_500_000
    p0 = dense.dense_raw(cfg, 2**31 + 5, cuda)
    st = S.from_params(GaussianParams(**p0))
    arrays = refcam.ring_arrays([0.0, 2.0], fc["width"], fc["height"])
    views = [types.SimpleNamespace(camera=c) for c in program_cameras(
        arrays, fc["width"], fc["height"], cuda)]
    passes = {}
    for pair_capacity in (1 << 20, fc["pair_capacity"]):
        lc = loops.LoopConfig(raster=RasterizeConfig(
            pair_capacity=pair_capacity,
            compact_capacity=min(pair_capacity, fc["compact_capacity"]),
            power_cutoff=fc["power_cutoff"]))
        view = loops.make_score_fn(lc)
        g, g_ovf = loops.metric_prune_scores(st, views, view)
        e, e_ovf = loops.metric_prune_scores(st, views, view.eager)
        assert torch.equal(g, e) and int(g_ovf) == int(e_ovf)
        assert view.graph.captures == 1
        passes[pair_capacity] = (g, int(g_ovf))
    assert passes[1 << 20][1] > 0 and passes[fc["pair_capacity"]][1] == 0
    cut = S.metric_prune(st, g, 0.02)
    assert int(st.live.sum() - cut.live.sum()) == int(1_500_000 * 0.02)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        view(st, views[0].camera)
        torch.cuda.synchronize()
    rep = profiling.window_report(prof.events())
    assert rep["unmatched"] == 0
    (graph,) = [v for v in rep["graphs"].values() if v["replays"]]
    stages = graph["stage_s"]
    assert {"project", "table", "expand", "sort", "gather", "stats",
            "reduce", "compose"} <= set(stages)
    assert stages.get("other", 0.0) < 0.01 * graph["device_s"]


def _dense_case(dev, n_ps1=20_000, n=100_000, w=W, h=H):
    """The dense proxy (benchmark/reference/dense.py) cut to n rows, its
    first n_ps1 the PS1 proxy's and the rest their split children
    (opacity logit N(-3, 1)), every seventh row dead; a ring camera at
    w x h; capacities past the candidates and kept pairs."""
    import json
    from pathlib import Path
    from benchmark.reference import camera as refcam
    from benchmark.reference import dense
    from benchmark.runners.frame_loop import program_cameras
    from fovsplat_torch.models.gaussians import GaussianParams
    root = Path(__file__).resolve().parents[1]
    cfg = json.loads((root / "benchmark/configs/bicycle-3dgs-dense.json")
                     .read_text())
    cfg["ps1_points"] = n_ps1
    cfg["frame"]["points"] = n
    st = S.from_params(GaussianParams(**dense.dense_raw(cfg, 2**31 + 7,
                                                        dev)))
    st = S.prune_mask(st, torch.arange(n, device=dev) % 7 == 3)
    arrays = refcam.ring_arrays([0.7], w, h)
    cams = [program_cameras(arrays, w, h, d)[0]
            for d in (dev, torch.device("cpu"))]
    raster = RasterizeConfig(pair_capacity=1 << 18,
                             power_cutoff=cfg["frame"]["power_cutoff"])
    return st, cams, raster


@pytest.mark.parametrize("mode", stats.MODES)
def test_score_route_on_kernel_10_matches_twin(cuda, mode, monkeypatch):
    """rasterize_stats on the card takes its columns from kernel 10's
    forward, one launch a call, on the dense proxy's rows: kernel 10's
    columns, valid, depth and radius equal the twin's bit for bit; the
    route with the model's SH pair and with one (N, 16, 3) tensor equals
    the same route with the twin (project_sh_plain, the torch glue it
    replaces) in every output bit for bit, and the CPU route with
    gs_count exact, contribs within 1e-5 relative and the render within
    1e-4."""
    st, (cam, cam_cpu), raster = _dense_case(cuda)
    p = st.params
    args = (p.xyz, p.get_scaling(), p.get_rotation(), p.get_opacity())
    pair = (p.features_dc, p.features_rest)
    with torch.no_grad():
        k = psh.project_sh_forward(*args, cam, shs=pair, live_mask=st.live)
        q = psh.project_sh_plain(*args, cam, shs=pair, live_mask=st.live)
    for name in ("diff", "aux", "valid", "depth", "radius"):
        assert _same_bits(getattr(k, name), getattr(q, name)), name
    assert int(k.valid.sum()) > 40_000
    lm = torch.rand((H, W), generator=torch.Generator().manual_seed(3))

    def run(shs, dev=cuda):
        return stats.rasterize_stats(
            *[a.to(dev) for a in args], cam if dev == cuda else cam_cpu,
            shs=shs, mode=mode, loss_map=lm.to(dev), config=raster,
            live_mask=st.live.to(dev))
    kernel = psh.project_sh_forward
    kernel.launches = 0
    got = [run(pair), run(psh.sh_tensor(pair))]
    assert kernel.launches == 2
    cpu = run(tuple(t.cpu() for t in pair), torch.device("cpu"))
    monkeypatch.setattr(psh, "project_sh_forward", psh.project_sh_plain)
    want = run(pair)
    assert kernel.launches == 2
    keys = ("render", "final_T", "gs_count", "contribs", "radii")
    for o in got:
        assert all(torch.equal(o[key], want[key]) for key in keys)
    assert int(want["binned"].overflow) == int(cpu["binned"].overflow) == 0
    assert int(want["binned"].num_pairs) == int(cpu["binned"].num_pairs)
    assert int((want["contribs"] > 0).sum()) > 2_000
    assert torch.equal(want["gs_count"].cpu(), cpu["gs_count"])
    torch.testing.assert_close(want["contribs"].cpu(), cpu["contribs"],
                               rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(want["render"].cpu(), cpu["render"], rtol=0,
                               atol=1e-4)


def test_graphed_score_view_launches_kernel_10(cuda, monkeypatch):
    """The graphed score view on the dense proxy launches kernel 10's
    forward once a view (its capture counts it, each replay adds one)
    and reaches no torch SH colour (sh.sh_to_rgb) on the card; graph and
    eager agree bit for bit."""
    st, (cam, _), raster = _dense_case(cuda)
    calls = []
    real = sh.sh_to_rgb
    monkeypatch.setattr(sh, "sh_to_rgb",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    view = loops.make_score_fn(loops.LoopConfig(raster=raster))
    first = view(st, cam)
    eager = view.eager(st, cam)
    assert not calls
    assert view.graph.launches_per_replay["project_sh_forward"] == 1
    psh.project_sh_forward.launches = 0
    for _ in range(3):
        again = view(st, cam)
    assert psh.project_sh_forward.launches == 3
    assert all(torch.equal(a, b) and torch.equal(a, c)
               for a, b, c in zip(first, eager, again))
    assert int(first[1]) == 0 and int((first[0] > 0).sum()) > 2_000


FETCH_GRID = (5, 4)          # tiles; an 80x64 grid
FETCH_CAP, FETCH_N = 16_384, 300
FETCH_CASES = ("no_inside", "never", "past_end", "rounds", "empty",
               "past_num_pairs", "padding")


def fetch_case(case, seed=6):
    """Kernel 14's inputs on one edge case, numpy: (first_trig (T, PIX)
    i32, seg_start (T+1,) i32, pair_gauss (FETCH_CAP,) i32, width,
    height). The frame is 75x55 on the 5x4 grid, so the last tile column
    and row hold padding pixels; every pixel freezes by a rank below a
    third of its segment's length unless the case says otherwise (long
    segments stop early); pair_gauss draws
    from FETCH_N Gaussians (each in many tiles), a few ids at or past
    FETCH_N inside the segments, and ids below FETCH_N past
    seg_start[T] (lanes past num_pairs). Cases: "no_inside": a 60x55
    frame, so the last column has no inside pixel and fetches nothing;
    "never": tiles where one inside pixel never freezes, one of them of
    5,000 pairs; "past_end": fetch points past the segment's end (length
    300, largest rank 290; length 257, rank 256); "rounds": largest ranks
    0, 255, 256, 511 and 512 in segments of 2,000; "empty": empty
    segments, the first and the last tile among them; "past_num_pairs":
    3,000 lanes past seg_start[T]; "padding": padding pixels that never
    freeze or freeze late, beside inside pixels that freeze early."""
    gx, gy = FETCH_GRID
    T, P = gx * gy, blend.PIX
    rng = np.random.default_rng(seed)
    width, height = 75, 55
    seg_len = rng.integers(1, 500, T)
    ft = np.zeros((T, P), np.int64)

    def freeze(t, top):
        ft[t] = rng.integers(0, max(top, 1), P)
    if case == "no_inside":
        width = 60
    elif case == "never":
        seg_len[7] = 5000
    elif case == "past_end":
        seg_len[[3, 8]] = (300, 257)
    elif case == "rounds":
        seg_len[[1, 2, 6, 11, 13]] = 2000
    elif case == "empty":
        seg_len[[0, 5, 6, T - 1]] = 0
    for t in range(T):
        freeze(t, seg_len[t] // 3)
    if case == "never":
        for t in (0, 7, 12):
            ft[t, rng.integers(0, P)] = blend.BIG
    elif case == "past_end":
        ft[3, 17], ft[8, 100] = 290, 256
        ft[3] = np.minimum(ft[3], 290)
        ft[8] = np.minimum(ft[8], 256)
    elif case == "rounds":
        for t, top in zip((1, 2, 6, 11, 13), (0, 255, 256, 511, 512)):
            ft[t] = rng.integers(0, top + 1, P)
            ft[t, 40] = top
    elif case == "padding":
        inside = blend.tile_inside_mask(gx, gy, width, height).numpy()
        for t in range(T):
            if not inside[t].all():
                ft[t] = rng.integers(0, 20, P)
                out = np.flatnonzero(~inside[t])
                ft[t, out] = np.where(rng.random(out.size) < 0.5, blend.BIG,
                                      seg_len[t] + 1000)
    seg = np.concatenate([[0], np.cumsum(seg_len)]).astype(np.int32)
    tail = 3000 if case == "past_num_pairs" else 40
    assert seg[-1] + tail <= FETCH_CAP
    gauss = rng.integers(0, FETCH_N, FETCH_CAP)
    for lane in rng.integers(0, seg[-1], 7):
        gauss[lane] = FETCH_N + rng.integers(0, 3)
    gauss[seg[-1] + tail:] = FETCH_N + 1
    return (ft.astype(np.int32), seg, gauss.astype(np.int32), width, height)


def _fetch_inputs(case, dev):
    """fetch_case's tensors on dev, pair_gauss turned into the score
    route's gid (FETCH_N past num_pairs, as rasterize_stats gives it)."""
    ft, seg, gauss, width, height = fetch_case(case)
    gid = np.where(np.arange(FETCH_CAP) < seg[-1], gauss, FETCH_N)
    return ([torch.from_numpy(a).to(dev)
             for a in (ft, seg, gid.astype(np.int32))]
            + [FETCH_N, FETCH_GRID[0], width, height])


@pytest.mark.parametrize("case", FETCH_CASES)
def test_fetch_count_edge_cases_match_plain(cuda, case):
    """Kernel 14 against its plain version, bit for bit, on each edge case
    of fetch_case; two launches equal, one launch each, and no count from
    a lane past num_pairs."""
    from fovsplat_torch.ops.kernels import fetch_count as fc
    args = _fetch_inputs(case, cuda)
    fc.fetch_count.launches = 0
    got = fc.fetch_count(*args)
    again = fc.fetch_count(*args)
    want = fc.fetch_count_plain(*args)
    assert fc.fetch_count.launches == 2
    assert got.dtype == torch.int32 and got.shape == (FETCH_N,)
    assert torch.equal(got, want) and torch.equal(got, again)
    assert 0 < int(got.sum()) < int(args[1][-1])


def _score_pairs(dev, n=200_000):
    """The score route's own inputs to kernel 14 on n rows of the PS1
    proxy at 320x224 (dense enough that some tiles stop early): kernel
    10's columns, kernel 4's pairs, kernel 8's first_trig and the gid row,
    as rasterize_stats builds them."""
    st = _train_state(dev, n, 2)
    cam = proxy.proxy_camera(W, H, device=dev)
    raster = RasterizeConfig(pair_capacity=1 << 21)
    p = st.params
    gx, gy = (cam.width + 15) // 16, (cam.height + 15) // 16
    with torch.no_grad():
        prep = psh.project_sh(p.xyz, p.get_scaling(), p.get_rotation(),
                              p.get_opacity(), cam,
                              shs=(p.features_dc, p.features_rest),
                              live_mask=st.live)
        pairs, bn = binning.bin_fused_ps1(
            psh.train_order(prep.aux, prep.diff), prep.valid, prep.depth,
            gx, gy, raster.pair_capacity, raster.kept_capacity(),
            raster.use_obb)
        first_trig = bs.blend_stats(pairs, bn.seg_start, gx, cam.width,
                                    cam.height, raster.power_cutoff)[5]
    lane = torch.arange(pairs.shape[1], device=dev)
    gid = torch.where(lane < bn.num_pairs, bn.pair_gauss, st.capacity)
    return ((first_trig, bn.seg_start, gid, st.capacity, gx, cam.width,
             cam.height), int(bn.num_pairs))


def test_fetch_count_matches_plain_on_score_pairs(cuda):
    """Kernel 14 on the score route's pairs (200k rows of the PS1 proxy
    at 320x224): equal to its plain version bit for bit, two launches
    equal, and the early exit engaged (fewer fetched pairs than kept
    ones)."""
    from fovsplat_torch.ops.kernels import fetch_count as fc
    args, num_pairs = _score_pairs(cuda)
    got = fc.fetch_count(*args)
    assert torch.equal(got, fc.fetch_count(*args))
    assert torch.equal(got, fc.fetch_count_plain(*args))
    assert 100_000 < int(got.sum()) < num_pairs


def test_graphed_score_view_launches_kernel_14(cuda):
    """The graphed score view launches kernel 14 once a view (its capture
    counts it, each replay adds one) for the metrics of the fetched-pair
    count and never for "max_contrib"; graph and eager agree bit for
    bit."""
    from fovsplat_torch.ops.kernels import fetch_count as fc
    st, (cam, _), raster = _dense_case(cuda)
    for metric, per_view in (("max_comp_efficiency", 1), ("surface", 1),
                             ("max_contrib", 0)):
        view = loops.make_score_fn(loops.LoopConfig(raster=raster), metric)
        first = view(st, cam)
        eager = view.eager(st, cam)
        assert view.graph.launches_per_replay.get("fetch_count", 0) == \
            per_view
        fc.fetch_count.launches = 0
        for _ in range(3):
            again = view(st, cam)
        assert fc.fetch_count.launches == 3 * per_view
        assert all(torch.equal(a, b) and torch.equal(a, c)
                   for a, b, c in zip(first, eager, again))
