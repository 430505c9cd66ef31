"""The port's CUDA kernels against their plain versions, on the card.

Skips without a GPU. On a machine with one (and without JAX), run
    python -m pytest --noconftest tests/test_torch_cuda.py -q
Integer outputs and kept counts must match exactly; tolerances as in
chip_smoke.py.
"""

import pytest
import torch

from fovsplat_torch import convert
from fovsplat_torch.data import proxy
from fovsplat_torch.ops import foveated as fov
from fovsplat_torch.ops import foveation
from fovsplat_torch.ops.kernels import blend_fov as bf
from fovsplat_torch.ops.kernels import build_table as bt
from fovsplat_torch.ops.kernels import expand_fov as ef
from fovsplat_torch.ops.rasterize import RasterizeConfig

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
