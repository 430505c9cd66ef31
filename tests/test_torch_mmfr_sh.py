"""The MM-FR frame in its packed SH form on the CPU, where every kernel
wrapper runs its plain twin: four independent level models at SH degree
3 (eval/mmfr.pack_level_models), each pass the PS1 frame's route over
the tiles it owns (rasterize.ps1_pairs: kernel 1p with the owned-tile
box, 4q, the fused-key sort, 5q), against the benchmark's plain
reference (benchmark/reference/mmfr.py), which imports no kernel of the
port. The frame runs on the card as one CUDA graph
(tests/test_torch_cuda.py).

A small seeded cloud of the benchmark's proxy at 80x56 on a ring camera;
alpha 0.3, at which every gaze below gives each of the four levels its
own tiles.
"""

import dataclasses

import pytest
import torch

from benchmark.reference import camera as refcam
from benchmark.reference import mmfr as ref_mmfr
from benchmark.reference import proxy as refproxy
from benchmark.reference import raster
from fovsplat_torch.data.cameras import Camera
from fovsplat_torch.eval import fps, mmfr
from fovsplat_torch.ops import foveation
from fovsplat_torch.ops.foveation import FoveationConfig
from fovsplat_torch.ops.kernels import build_table as bt
from fovsplat_torch.ops.kernels import expand_ps1 as ep1
from fovsplat_torch.ops.rasterize import RasterizeConfig, pack_ps1_model
from tests.torch_cpu import one_torch_thread  # noqa: F401

W, H = 80, 56
GX, GY = (W + 15) // 16, (H + 15) // 16
PNUM = [1500, 602, 327, 262]
ALPHA = 0.3
GAZES = [(0.5, 0.5), (0.2, 0.8), (0.9, 0.1)]
# The frame cells' pixel limit (benchmark/limits/*.json): the quantized
# rows are the reference's own, so what is left is f32 rounding.
IMAGE_ATOL = 1e-3
FRAME = {"alpha": ALPHA, "foveation": dataclasses.asdict(FoveationConfig()),
         "pair_capacity": [1 << 14] * 4, "compact_capacity": [1 << 13] * 4,
         "power_cutoff": -4.5, "reference_chunk": 4096,
         "lowpass": [0.3, 0.0]}



@pytest.fixture(scope="module")
def scene():
    sc = refproxy.bicycle_proxy(PNUM[0], 2**31 + 5, "cpu", PNUM)
    arrays = refcam.ring_arrays([0.4], W, H)
    t = {k: torch.as_tensor(arrays[k]) for k in arrays}
    cam = Camera(t["world_view"][0], t["full_proj"][0], t["cam_center"][0],
                 t["tan_fovx"], t["tan_fovy"], W, H)
    models = mmfr.pack_level_models(
        sc["means"], sc["scales"], sc["rotations"], sc["opacities4"],
        sc["shs_dcs"], sc["shs_rest"], sc["highest_levels"], PNUM)
    return {"sc": sc, "cam": cam, "models": models,
            "refcam": refcam.ref_camera(arrays, 0, W, H, "cpu")}


def test_level_models_follow_the_reference_rule(scene):
    """Level li holds PNUM[li] rows, all at SH degree 3: the rows the
    reference's rule selects, with their level-li opacity and DC in
    bf16."""
    ref = ref_mmfr.level_models(scene["sc"], PNUM)
    for li, (m, r) in enumerate(zip(scene["models"], ref)):
        assert m.xyz.shape[0] == PNUM[li] and m.sh_t.shape[:2] == (3, 16)
        assert torch.equal(m.xyz, r["means"])
        assert torch.equal(m.opac, r["opacity"].to(torch.bfloat16))
        assert torch.equal(m.sh_t[:, 0].T, r["dc"].to(torch.bfloat16))
        assert torch.equal(m.sh_t[:, 1:].permute(2, 1, 0),
                           r["shs_rest"].to(torch.bfloat16))
    hl = scene["sc"]["highest_levels"]
    assert int((hl >= 3).sum()) <= PNUM[3] < PNUM[2] <= int((hl >= 1).sum())


@pytest.mark.parametrize("gaze", GAZES)
def test_sh_frame_matches_reference(scene, gaze):
    """The eager SH-form frame (make_mmfr_render on CPU tensors) against
    the plain reference: pixels within the frame cells' limit, and pair
    counts, overflow and candidates equal pass by pass."""
    cfgs = [RasterizeConfig(pair_capacity=p, compact_capacity=k)
            for p, k in zip(FRAME["pair_capacity"], FRAME["compact_capacity"])]
    render = fps.make_mmfr_render(scene["models"], cfgs, alpha=ALPHA)
    assert not hasattr(render, "graph")
    g = torch.tensor(gaze)
    out = render(scene["cam"], g)
    img, counts, work = ref_mmfr.mmfr_frame(scene["sc"], scene["refcam"], g,
                                            FRAME, PNUM)
    gap = float((out["render"] - img).abs().max())
    assert gap <= IMAGE_ATOL, gap
    got = [(int(d["num_pairs"]), int(d["overflow"]), int(d["candidates"]))
           for d in out["passes"]]
    want = [(p["num_pairs"], p["overflow"], p["candidates"])
            for p in work["passes"]]
    assert got == want
    assert int(out["num_pairs"]) == counts["num_pairs"]
    assert int(out["overflow"]) == 0
    # Every pass owns tiles and blends pairs there.
    assert all(p["kept"] > 0 for p in work["passes"])
    assert float(out["render"].abs().sum()) > 0


def _tables(model, cam, box):
    return bt.build_table_ps1(model, cam, box=box)


@pytest.mark.parametrize("case", ["whole_grid", "sub_box", "dead_rows"])
def test_ps1_table_box_against_no_box(scene, case):
    """Kernel 1p's plain twin with an owned-tile box against its result
    without one: a box over the whole grid changes nothing; a smaller
    box clips each rect (rows with no tile left become invalid, the OBB
    extents keep the pre-clip count); with a box, rows of opacity below
    1/255 are culled, without one they are not."""
    m = scene["models"][0]
    if case == "dead_rows":
        op = m.opac.clone()
        op[::7] = 0.003
        m = dataclasses.replace(m, opac=op)
    cam = scene["cam"]
    box = torch.tensor([0, 0, GX, GY] if case != "sub_box"
                       else [1, 1, GX - 1, GY - 2], dtype=torch.int32)
    t0, c0, n0 = _tables(m, cam, None)
    t1, c1, n1 = _tables(m, cam, box)
    if case == "whole_grid":
        assert torch.equal(t0, t1) and torch.equal(c0, c1)
        assert torch.equal(n0, n1)
        return
    v0 = t0[ep1.ROW_TNUM] > 0
    if case == "dead_rows":
        dead = m.opac.float() < 1.0 / 255.0
        want = v0 & ~dead
        assert int((v0 & dead).sum()) > 10
        assert torch.equal(t1[:, want], t0[:, want])
    else:
        rx0 = torch.clamp(t0[ep1.ROW_RX0], min=1)
        ry0 = torch.clamp(t0[ep1.ROW_RY0], min=1)
        rx1 = torch.clamp(t0[ep1.ROW_RX0] + t0[ep1.ROW_RW], max=GX - 1)
        ry1 = torch.clamp(t0[ep1.ROW_RY0]
                          + t0[ep1.ROW_TNUM] / t0[ep1.ROW_RW], max=GY - 2)
        tnum = torch.clamp(rx1 - rx0, min=0) * torch.clamp(ry1 - ry0, min=0)
        want = v0 & (tnum > 0)
        assert 0 < int(want.sum()) < int(v0.sum())
        assert torch.equal(t1[ep1.ROW_RX0, want], rx0[want])
        assert torch.equal(t1[ep1.ROW_RY0, want], ry0[want])
        assert torch.equal(t1[ep1.ROW_RW, want], (rx1 - rx0)[want])
        assert torch.equal(t1[ep1.ROW_TNUM, want], tnum[want])
        assert torch.equal(t1[ep1.ROW_MX:, want], t0[ep1.ROW_MX:, want])
        assert int((t1[ep1.ROW_TNUM] < t0[ep1.ROW_TNUM])[want].sum()) > 0
    # Rows the box removes carry the sanitised column.
    gone = ~want
    assert torch.equal(t1[:, gone], t1[:, gone][:, :1].expand(-1,
                                                            int(gone.sum())))
    assert int(t1[ep1.ROW_TNUM, gone].abs().sum()) == 0
    inc = torch.cumsum(t1[ep1.ROW_TNUM].to(torch.int32), 0, dtype=torch.int32)
    assert torch.equal(c1, inc - t1[ep1.ROW_TNUM].to(torch.int32))
    assert int(n1) == int(inc[-1])


@pytest.mark.parametrize("gaze", GAZES)
def test_ownership_partitions_the_tiles(gaze):
    """The four ownership masks partition the tiles, each box is its
    mask's bbox, and both equal the reference's."""
    g = torch.tensor(gaze)
    levels = foveation.compute_tile_levels(g, W, H, ALPHA)
    boxes, masks = mmfr.tile_ownership(levels.to(torch.int32), GX, GY, 4)
    assert boxes.dtype == torch.int32 and masks.shape == (4, GX * GY)
    assert torch.equal(masks.sum(0), torch.ones(GX * GY, dtype=torch.int64))
    for li in range(4):
        ty, tx = torch.nonzero(masks[li].reshape(GY, GX), as_tuple=True)
        assert tx.numel() > 0
        assert boxes[li].tolist() == [int(tx.min()), int(ty.min()),
                                      int(tx.max()) + 1, int(ty.max()) + 1]
    ref_lv = raster.tile_levels(g, W, H, ALPHA, FRAME["foveation"])[0]
    own, box = ref_mmfr.ownership(ref_lv, GX, GY, 4)
    assert torch.equal(own, masks) and torch.equal(box.int(), boxes)


def test_empty_level_owns_no_tile():
    """A level that owns no tile gets an empty box, which clips every
    rect away: its pass makes no pair."""
    level_i = torch.zeros(GX * GY, dtype=torch.int32)
    boxes, masks = mmfr.tile_ownership(level_i, GX, GY, 4)
    assert bool(masks[0].all()) and not bool(masks[1:].any())
    assert boxes[0].tolist() == [0, 0, GX, GY]
    for b in boxes[1:]:
        assert b[0] >= b[2] and b[1] >= b[3]


def test_packed_model_of_one_level_is_the_ps1_model(scene):
    """pack_level_models packs each level as pack_ps1_model does."""
    sc = scene["sc"]
    keep = torch.sort(torch.sort(sc["highest_levels"], descending=True,
                                 stable=True)[1][:PNUM[2]])[0]
    want = pack_ps1_model(sc["means"][keep], sc["scales"][keep],
                          sc["rotations"][keep], sc["opacities4"][keep, 2],
                          sc["shs_dcs"][keep, 2:3], sc["shs_rest"][keep])
    got = scene["models"][2]
    for f in dataclasses.fields(want):
        assert torch.equal(getattr(got, f.name), getattr(want, f.name))


def test_composed_level_models_keep_the_live_rows_of_each_level(scene):
    """composed_level_models (the CLI's `fps --mode mmfr`): level li
    holds the live rows of highest level >= li, in row order, with their
    level-li opacity and DC, the SH rest and the activated geometry."""
    from fovsplat_torch.models.gaussians import GaussianParams
    from fovsplat_torch.train.compose import ComposedModel
    sc = scene["sc"]
    n = sc["means"].shape[0]
    params = GaussianParams(
        sc["means"], sc["shs_dcs"][:, :1], sc["shs_rest"],
        torch.log(sc["scales"]), 2.0 * sc["rotations"],
        torch.zeros((n, 1)))
    live = torch.arange(n) % 5 != 3
    composed = ComposedModel(params=params, live=live,
                             highest_levels=sc["highest_levels"],
                             shs_dcs=sc["shs_dcs"],
                             opacities=sc["opacities4"])
    models = mmfr.composed_level_models(composed)
    assert len(models) == 4
    for li, m in enumerate(models):
        rows = torch.nonzero(live & (sc["highest_levels"] >= li))[:, 0]
        assert m.xyz.shape[0] == rows.numel() > 0
        want = pack_ps1_model(
            sc["means"][rows], params.get_scaling()[rows].detach(),
            params.get_rotation()[rows].detach(),
            sc["opacities4"][rows, li], sc["shs_dcs"][rows, li:li + 1],
            sc["shs_rest"][rows])
        for f in dataclasses.fields(want):
            assert torch.equal(getattr(m, f.name), getattr(want, f.name)), f
