"""The port's CUDA kernels against their plain versions, on the card.

Skips without a GPU. On a machine with one (and without JAX), run
    python -m pytest --noconftest tests/test_torch_cuda.py -q
Integer outputs and kept counts must match exactly; tolerances as in
chip_smoke.py.
"""

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
from fovsplat_torch.ops.kernels import segment_reduce as sr
from fovsplat_torch.ops.rasterize import RasterizeConfig
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
    CPU plain path, and one launch of each train kernel per step."""
    n, w, h = 5000, 160, 112
    gt = np.random.default_rng(1).uniform(0, 1, (h, w, 3)).astype(np.float32)
    cfg = loops.LoopConfig(raster=RasterizeConfig(pair_capacity=1 << 20))
    kernels = (ep1.expand_ps1, bfw.blend_forward, bfw.blend_backward,
               sr.reduce_by_sorted_gid)
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
    assert nc == [1, 1, 1, 1] and nh == [0, 0, 0, 0]
    assert int(bc) == int(bh) == 0
    assert int(oc["binned"].overflow) == int(oh["binned"].overflow) == 0
    assert int(oc["binned"].num_pairs) == int(oh["binned"].num_pairs) > 1000
    torch.testing.assert_close(lc.cpu(), lh, rtol=1e-5, atol=0)
    for f, g in gh.items():
        scale = float(g.abs().max())
        torch.testing.assert_close(gc[f].cpu() / scale, g / scale,
                                   rtol=2e-3, atol=2e-4, msg=f)


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
        scores = [loops.make_score_fn(cfg, m)(st, cam).cpu()
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
