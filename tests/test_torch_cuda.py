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
