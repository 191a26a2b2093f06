"""Exact ASW and box aggregation vs the NumPy loop oracle, over the
geometry matrix the fused kernels were once tested on: both weight modes,
both costs, wide images, edge geometries (r=0, tiny D, odd shapes), both
box cost kinds, random configs, and the tiled/chunked/sharded layouts.

Each case compares the jnp path (``pipeline``/``aggregate``) with
``models/oracle_numpy`` at the same parameters: aggregated volumes to f32
tolerance (the oracle accumulates in float64), WTA winners, the right-view
winners and the parabola triple.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from aswstereomatch_tpu.config import StereoConfig
from aswstereomatch_tpu.models import oracle_numpy as oracle
from aswstereomatch_tpu.models import pipeline
from aswstereomatch_tpu.ops import postprocess
from aswstereomatch_tpu.utils import synthetic


def J(fn, **static):
    return jax.jit(functools.partial(fn, **static))


CFG = StereoConfig(
    max_disparity=8, cost="tad_grad", aggregation="asw", window_radius=2,
    gamma_color=14.0, gamma_spatial=9.0,
)
FULL = dict(lr_check=True, fill_holes=True, subpixel=True, median_filter=True)


def _pair(h, w, D, seed, **kw):
    return synthetic.make_pair(height=h, width=w, max_disparity=D, seed=seed,
                               **kw)


def check_volume_vs_oracle(cfg, pair, wta_share=0.999):
    """jnp aggregated volume and its winners vs the loop oracle's."""
    l, r = jnp.asarray(pair["left"]), jnp.asarray(pair["right"])
    vol = np.asarray(J(pipeline.aggregated_volume, cfg=cfg)(l, r))
    vol_o = oracle.aggregated_volume(pair["left"], pair["right"], cfg)
    np.testing.assert_allclose(vol, vol_o, rtol=2e-4, atol=2e-3)
    bd, bd_o = np.argmin(vol, -1), np.argmin(vol_o, -1)
    assert np.mean(bd == bd_o) >= wta_share
    volr = np.asarray(J(postprocess.right_volume)(jnp.asarray(vol)))
    assert np.mean(np.argmin(volr, -1)
                   == np.argmin(oracle.right_volume(vol_o), -1)) >= wta_share
    # parabola triple at the shared winners
    D = cfg.max_disparity
    take = lambda v, i: np.take_along_axis(v, i[..., None], -1)[..., 0]
    same = (bd == bd_o) & (bd > 0) & (bd < D - 1)
    for off in (-1, 1):
        np.testing.assert_allclose(
            take(vol, (bd + off).clip(0, D - 1))[same],
            take(vol_o, (bd + off).clip(0, D - 1))[same],
            rtol=2e-4, atol=2e-3,
        )
    return vol, vol_o


def check_pipeline_vs_oracle(cfg, pair, agree_min=0.99):
    l, r = jnp.asarray(pair["left"]), jnp.asarray(pair["right"])
    d = np.asarray(J(pipeline.match_pair, cfg=cfg)(l, r))
    d_o = oracle.match_pair(pair["left"], pair["right"], cfg)
    agree = np.mean(np.abs(d - d_o) <= 0.51)
    assert agree > agree_min, f"disagreement {1 - agree:.4%}"
    assert np.mean(np.abs(d - d_o) > 2.0) < 0.005
    return d


@pytest.mark.parametrize(
    "cfg,shape",
    [
        (CFG, (24, 40)),
        (CFG.replace(asw_symmetric=False), (24, 40)),
        (CFG.replace(cost="ad"), (24, 40)),
        (CFG, (16, 200)),  # wide image
    ],
    ids=["symmetric", "left_only", "ad_cost", "multi_xtile"],
)
def test_exact_volume_matches_oracle(cfg, shape):
    check_volume_vs_oracle(cfg, _pair(*shape, cfg.max_disparity, seed=3))


def test_pipeline_matches_oracle_end_to_end():
    check_pipeline_vs_oracle(CFG.replace(**FULL), _pair(24, 40, 8, seed=5))


def test_unsupported_layout_modes_rejected():
    """Layouts refuse the aggregations they cannot reproduce exactly."""
    from aswstereomatch_tpu.parallel import dshard, tiling
    from aswstereomatch_tpu.parallel import mesh as mesh_lib

    m = mesh_lib.build_mesh(data=1, tile=2)
    z = jnp.zeros((8, 64, 3))
    with pytest.raises(ValueError, match="x-tiling"):
        tiling.match_pair_tiled_x(z, z, CFG.replace(aggregation="none"), m)
    with pytest.raises(ValueError, match="disparity sharding"):
        dshard.match_pair_dsharded(z, z, CFG.replace(aggregation="none"), m)
    with pytest.raises(ValueError, match="unknown aggregation"):
        CFG.replace(aggregation="bogus")


def test_tiled_equals_untiled_exactly_small_window():
    from aswstereomatch_tpu.parallel import mesh as mesh_lib
    from aswstereomatch_tpu.parallel import tiling

    cfg = CFG.replace(**FULL)
    pair = _pair(48, 40, 8, seed=8)
    l, r = jnp.asarray(pair["left"]), jnp.asarray(pair["right"])
    ref = np.asarray(J(pipeline.match_pair, cfg=cfg)(l, r))
    m = mesh_lib.build_mesh(data=1, tile=4)
    out = np.asarray(J(tiling.match_pair_tiled, cfg=cfg, device_mesh=m)(l, r))
    np.testing.assert_array_equal(out, ref)


def test_chunked_equals_unchunked_exactly_small_window():
    cfg = CFG.replace(**FULL)
    pair = _pair(48, 40, 8, seed=9)
    l, r = jnp.asarray(pair["left"]), jnp.asarray(pair["right"])
    ref = np.asarray(J(pipeline.match_pair, cfg=cfg)(l, r))
    out = np.asarray(J(pipeline.match_pair, cfg=cfg.replace(y_chunks=3))(l, r))
    np.testing.assert_array_equal(out, ref)


def test_batch_matches_single():
    cfg = CFG.replace(**FULL)
    p1, p2 = _pair(24, 40, 8, seed=1), _pair(24, 40, 8, seed=2)
    lb = jnp.stack([jnp.asarray(p1["left"]), jnp.asarray(p2["left"])])
    rb = jnp.stack([jnp.asarray(p1["right"]), jnp.asarray(p2["right"])])
    outs = np.asarray(J(pipeline.match_batch, cfg=cfg)(lb, rb))
    for i, p in enumerate((p1, p2)):
        ref = np.asarray(J(pipeline.match_pair, cfg=cfg)(
            jnp.asarray(p["left"]), jnp.asarray(p["right"])))
        np.testing.assert_allclose(outs[i], ref, atol=1e-4)


@pytest.mark.parametrize(
    "r,D,shape",
    [
        (0, 2, (13, 24)),   # degenerate window, odd height
        (1, 4, (11, 40)),   # minimal real window
        (2, 8, (8, 128)),   # short, wide
    ],
    ids=["r0_d2", "r1_d4", "one_tile"],
)
def test_edge_geometries_match_oracle(r, D, shape):
    cfg = CFG.replace(max_disparity=D, window_radius=r)
    check_volume_vs_oracle(cfg, _pair(*shape, D, seed=6, num_layers=1))


@pytest.mark.parametrize("cost_kind", ["ad", "tad_grad"])
def test_box_volume_matches_oracle(cost_kind):
    cfg = CFG.replace(aggregation="box", cost=cost_kind, window_radius=3)
    check_volume_vs_oracle(cfg, _pair(24, 40, 8, seed=12))


def test_box_pipeline_matches_oracle():
    cfg = CFG.replace(aggregation="box", window_radius=3, **FULL)
    check_pipeline_vs_oracle(cfg, _pair(24, 40, 8, seed=13))


@pytest.mark.parametrize("seed", range(8))
def test_fuzz_random_configs_vs_oracle(seed):
    """Random small configs: the jnp volume's winners track the oracle."""
    rng = np.random.default_rng(100 + seed)
    cfg = CFG.replace(
        max_disparity=int(rng.choice([4, 8, 12])),
        window_radius=int(rng.choice([1, 2, 3])),
        cost=str(rng.choice(["ad", "tad_grad"])),
        asw_symmetric=bool(rng.choice([True, False])),
        aggregation=str(rng.choice(["asw", "box"])),
        gamma_color=float(rng.uniform(5, 30)),
        gamma_spatial=float(rng.uniform(5, 40)),
        alpha=float(rng.uniform(0.5, 1.0)),
    )
    h = int(rng.integers(10, 30))
    w = int(rng.integers(20, 60))
    # AD costs of 8-bit images tie exactly (multiples of 1/3); the oracle
    # sums in float64, so such ties may break the other way on a few pixels
    check_volume_vs_oracle(cfg, _pair(h, w, cfg.max_disparity, seed=seed),
                           wta_share=0.99)


def test_xtiled_equals_untiled_exactly_nondivisible():
    """x-tiling (halo exchange + right-view strip merge) stays bit-exact,
    including a width that does not divide by the shard count."""
    from aswstereomatch_tpu.parallel import mesh as mesh_lib
    from aswstereomatch_tpu.parallel import tiling

    cfg = CFG.replace(**FULL)
    for wdt in (64, 61):
        pair = _pair(24, wdt, 8, seed=8)
        l, r = jnp.asarray(pair["left"]), jnp.asarray(pair["right"])
        ref = np.asarray(J(pipeline.match_pair, cfg=cfg)(l, r))
        m = mesh_lib.build_mesh(data=1, tile=2)
        out = np.asarray(
            J(tiling.match_pair_tiled_x, cfg=cfg, device_mesh=m)(l, r))
        np.testing.assert_array_equal(out, ref)


def test_dsharded_equals_unsharded_exactly_d16():
    from aswstereomatch_tpu.parallel import dshard
    from aswstereomatch_tpu.parallel import mesh as mesh_lib

    cfg = CFG.replace(max_disparity=16, **FULL)
    pair = _pair(24, 40, 16, seed=4)
    l, r = jnp.asarray(pair["left"]), jnp.asarray(pair["right"])
    ref = np.asarray(J(pipeline.match_pair, cfg=cfg)(l, r))
    m = mesh_lib.build_mesh(data=1, tile=4)
    out = np.asarray(
        J(dshard.match_pair_dsharded, cfg=cfg, device_mesh=m)(l, r))
    np.testing.assert_array_equal(out, ref)


def test_dsharded_box_rejected():
    """d-sharded box aggregation is unsupported: it raises, never silently
    computes another layout."""
    from aswstereomatch_tpu.parallel import dshard
    from aswstereomatch_tpu.parallel import mesh as mesh_lib

    m = mesh_lib.build_mesh(data=1, tile=4)
    pair = _pair(24, 40, 16, seed=4)
    l, r = jnp.asarray(pair["left"]), jnp.asarray(pair["right"])
    cfg = CFG.replace(max_disparity=16, aggregation="box", **FULL)
    with pytest.raises(ValueError, match="disparity sharding"):
        dshard.match_pair_dsharded(l, r, cfg, m)
