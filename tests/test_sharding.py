"""Sharding tests on 8 virtual CPU devices (SURVEY.md section 4.3).

The load-bearing invariant: tiled output == untiled output **exactly**
(bit-for-bit f32) — same ops in the same order by construction, halo
exchange only changes where rows live.  Covers divisible and non-divisible
heights (bottom padding), full post-processing on, data x tile batch mode,
and halo-too-small validation.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from aswstereomatch_tpu.config import StereoConfig
from aswstereomatch_tpu.models import pipeline
from aswstereomatch_tpu.parallel import mesh as mesh_lib
from aswstereomatch_tpu.parallel import tiling
from aswstereomatch_tpu.utils import synthetic


def J(fn, **static):
    return jax.jit(functools.partial(fn, **static))


CFG_FULL = StereoConfig(
    max_disparity=16, cost="tad_grad", aggregation="asw", window_radius=4,
    gamma_color=14.0, gamma_spatial=9.0,
    lr_check=True, fill_holes=True, subpixel=True, median_filter=True,
)
CFG_BOX = StereoConfig(
    max_disparity=16, cost="ad", aggregation="box", window_radius=4,
    lr_check=False, fill_holes=False, subpixel=False, median_filter=True,
)


@pytest.fixture(scope="module")
def pair96():
    return synthetic.make_pair(height=96, width=64, max_disparity=16, seed=13)


@pytest.mark.parametrize("cfg", [CFG_FULL, CFG_BOX], ids=["asw_full", "ad_box"])
@pytest.mark.parametrize("ntile", [2, 4, 8])
def test_tiled_equals_untiled_exactly(pair96, cfg, ntile):
    left = jnp.asarray(pair96["left"])
    right = jnp.asarray(pair96["right"])
    ref = np.asarray(J(pipeline.match_pair, cfg=cfg)(left, right))
    m = mesh_lib.build_mesh(data=1, tile=ntile)
    out = np.asarray(
        J(tiling.match_pair_tiled, cfg=cfg, device_mesh=m)(left, right)
    )
    np.testing.assert_array_equal(out, ref)


def test_tiled_nondivisible_height_exact():
    pair = synthetic.make_pair(height=94, width=64, max_disparity=16, seed=4)
    left, right = jnp.asarray(pair["left"]), jnp.asarray(pair["right"])
    ref = np.asarray(J(pipeline.match_pair, cfg=CFG_FULL)(left, right))
    m = mesh_lib.build_mesh(data=1, tile=4)
    out = np.asarray(
        J(tiling.match_pair_tiled, cfg=CFG_FULL, device_mesh=m)(left, right)
    )
    assert out.shape == ref.shape == (94, 64)
    np.testing.assert_array_equal(out, ref)


def test_batch_sharded_matches_per_pair(pair96):
    m = mesh_lib.build_mesh(data=2, tile=4)
    pair2 = synthetic.make_pair(height=96, width=64, max_disparity=16, seed=77)
    lefts = jnp.asarray(np.stack([pair96["left"], pair2["left"]]))
    rights = jnp.asarray(np.stack([pair96["right"], pair2["right"]]))
    outs = np.asarray(
        J(tiling.match_batch_sharded, cfg=CFG_FULL, device_mesh=m)(lefts, rights)
    )
    for i in range(2):
        ref = np.asarray(
            J(pipeline.match_pair, cfg=CFG_FULL)(lefts[i], rights[i])
        )
        np.testing.assert_array_equal(outs[i], ref)


def test_halo_too_small_raises(pair96):
    m = mesh_lib.build_mesh(data=1, tile=8)
    cfg = CFG_FULL.replace(window_radius=16)  # halo 17 > 12 rows/shard
    with pytest.raises(ValueError, match="halo"):
        tiling.match_pair_tiled(
            jnp.asarray(pair96["left"]), jnp.asarray(pair96["right"]), cfg, m
        )


def test_mesh_validation():
    with pytest.raises(ValueError, match="devices"):
        mesh_lib.build_mesh(data=4, tile=4)


def test_chunked_equals_unchunked_exactly(pair96):
    """Memory-streaming y_chunks mode is bit-identical to one-shot."""
    left = jnp.asarray(pair96["left"])
    right = jnp.asarray(pair96["right"])
    ref = np.asarray(J(pipeline.match_pair, cfg=CFG_FULL)(left, right))
    for n in (3, 4):
        cfg = CFG_FULL.replace(y_chunks=n)
        out = np.asarray(J(pipeline.match_pair, cfg=cfg)(left, right))
        np.testing.assert_array_equal(out, ref)


def test_dsharded_equals_unsharded_exactly(pair96):
    """Disparity-axis sharding (TP analog): bit-identical to unsharded."""
    from aswstereomatch_tpu.parallel import dshard

    cfg = CFG_FULL  # D=16 over 4 shards
    left = jnp.asarray(pair96["left"])
    right = jnp.asarray(pair96["right"])
    ref = np.asarray(J(pipeline.match_pair, cfg=cfg)(left, right))
    m = mesh_lib.build_mesh(data=1, tile=4)
    out = np.asarray(
        J(dshard.match_pair_dsharded, cfg=cfg, device_mesh=m)(left, right)
    )
    np.testing.assert_array_equal(out, ref)


def test_dshard_validates_divisibility(pair96):
    from aswstereomatch_tpu.parallel import dshard

    m = mesh_lib.build_mesh(data=1, tile=3)
    with pytest.raises(ValueError, match="divisible"):
        dshard.match_pair_dsharded(
            jnp.asarray(pair96["left"]), jnp.asarray(pair96["right"]),
            CFG_FULL, m,
        )


def test_xtiled_equals_untiled_exactly(pair96):
    """x-tiling with the D_max right-image halo: bit-identical to untiled."""
    cfg = CFG_FULL
    left = jnp.asarray(pair96["left"])   # (96, 64): 4 shards x 16 cols
    right = jnp.asarray(pair96["right"])
    ref = np.asarray(J(pipeline.match_pair, cfg=cfg)(left, right))
    # 64 cols / 2 shards = 32 >= halo (r + D - 1 = 19)
    m = mesh_lib.build_mesh(data=1, tile=2)
    out = np.asarray(
        J(tiling.match_pair_tiled_x, cfg=cfg, device_mesh=m)(left, right)
    )
    np.testing.assert_array_equal(out, ref)

    wide = synthetic.make_pair(height=48, width=128, max_disparity=16, seed=31)
    lw, rw = jnp.asarray(wide["left"]), jnp.asarray(wide["right"])
    ref_w = np.asarray(J(pipeline.match_pair, cfg=cfg)(lw, rw))
    m4 = mesh_lib.build_mesh(data=1, tile=4)
    out_w = np.asarray(
        J(tiling.match_pair_tiled_x, cfg=cfg, device_mesh=m4)(lw, rw)
    )
    np.testing.assert_array_equal(out_w, ref_w)


def test_xtiled_nondivisible_width_exact():
    pair = synthetic.make_pair(height=48, width=61, max_disparity=8, seed=21)
    cfg = CFG_FULL.replace(max_disparity=8)
    left, right = jnp.asarray(pair["left"]), jnp.asarray(pair["right"])
    ref = np.asarray(J(pipeline.match_pair, cfg=cfg)(left, right))
    m = mesh_lib.build_mesh(data=1, tile=2)
    out = np.asarray(
        J(tiling.match_pair_tiled_x, cfg=cfg, device_mesh=m)(left, right)
    )
    assert out.shape == ref.shape == (48, 61)
    np.testing.assert_array_equal(out, ref)


def test_xtiled_halo_validation(pair96):
    m = mesh_lib.build_mesh(data=1, tile=8)  # 8 cols/shard < halo 19
    with pytest.raises(ValueError, match="halo"):
        tiling.match_pair_tiled_x(
            jnp.asarray(pair96["left"]), jnp.asarray(pair96["right"]),
            CFG_FULL, m,
        )


def test_tiled_weighted_median_exact(pair96):
    """y-tiling stays bit-exact with the weighted median variant."""
    cfg = CFG_FULL.replace(median_mode="weighted")
    left = jnp.asarray(pair96["left"])
    right = jnp.asarray(pair96["right"])
    ref = np.asarray(J(pipeline.match_pair, cfg=cfg)(left, right))
    m = mesh_lib.build_mesh(data=1, tile=4)
    out = np.asarray(
        J(tiling.match_pair_tiled, cfg=cfg, device_mesh=m)(left, right)
    )
    np.testing.assert_array_equal(out, ref)


def test_reshard_roundtrip_and_layout(pair96):
    """Ulysses-analog all_to_all: x-sharded <-> d-sharded volume layouts."""
    from aswstereomatch_tpu.parallel import reshard

    rng = np.random.default_rng(5)
    vol = rng.random((16, 32, 8)).astype(np.float32)  # (H, W, D)
    m = mesh_lib.build_mesh(data=1, tile=4)
    from jax.sharding import NamedSharding, PartitionSpec as P

    vx = jax.device_put(vol, NamedSharding(m, P(None, "tile", None)))
    vd = J(reshard.x_to_d, device_mesh=m)(vx)
    # value must be unchanged, only the layout moved
    np.testing.assert_array_equal(np.asarray(vd), vol)
    back = J(reshard.d_to_x, device_mesh=m)(vd)
    np.testing.assert_array_equal(np.asarray(back), vol)


def test_config_driven_sharded_api(pair96):
    """parallel.api: the config's declared mesh layout drives the run."""
    from aswstereomatch_tpu.parallel import api

    left = jnp.asarray(pair96["left"])
    right = jnp.asarray(pair96["right"])
    ref = np.asarray(J(pipeline.match_pair, cfg=CFG_FULL)(left, right))
    for axis in ("y", "d"):
        cfg = CFG_FULL.replace(mesh_data=1, mesh_tile=4, tile_axis=axis)
        out = np.asarray(jax.jit(api.sharded_match_fn(cfg))(left, right))
        np.testing.assert_array_equal(out, ref)
    # 1x1 layout falls back to the plain pipeline
    fn = api.sharded_match_fn(CFG_FULL)
    np.testing.assert_array_equal(np.asarray(jax.jit(fn)(left, right)), ref)


def test_sharded_api_fallback_warns(pair96):
    from aswstereomatch_tpu.parallel import api

    cfg = CFG_FULL.replace(mesh_data=16, mesh_tile=16)  # > 8 devices
    with pytest.warns(UserWarning, match="running unsharded"):
        fn = api.sharded_match_fn(cfg)
    out = jax.jit(fn)(
        jnp.asarray(pair96["left"]), jnp.asarray(pair96["right"])
    )
    assert out.shape == pair96["gt"].shape


def test_xtiled_weighted_median_exact(pair96):
    """x-tiling with the weighted median (gathered Lab guide) is bit-exact."""
    cfg = CFG_FULL.replace(median_mode="weighted")
    left = jnp.asarray(pair96["left"])
    right = jnp.asarray(pair96["right"])
    ref = np.asarray(J(pipeline.match_pair, cfg=cfg)(left, right))
    m = mesh_lib.build_mesh(data=1, tile=2)
    out = np.asarray(
        J(tiling.match_pair_tiled_x, cfg=cfg, device_mesh=m)(left, right)
    )
    np.testing.assert_array_equal(out, ref)


def test_xtiled_box_exact(pair96):
    """x-tiling with box aggregation (jnp path): bit-exact vs untiled."""
    cfg = CFG_BOX.replace(lr_check=True, fill_holes=True, subpixel=True)
    left = jnp.asarray(pair96["left"])
    right = jnp.asarray(pair96["right"])
    ref = np.asarray(J(pipeline.match_pair, cfg=cfg)(left, right))
    m = mesh_lib.build_mesh(data=1, tile=2)
    out = np.asarray(
        J(tiling.match_pair_tiled_x, cfg=cfg, device_mesh=m)(left, right)
    )
    np.testing.assert_array_equal(out, ref)


def test_left_only_sharded_layouts_match_xlanes_exactly(pair96):
    """Left-only ASW through every sharded layout — y-tiled, d-sharded,
    x-tiled and the batched DP x SP mesh — is bit-exact vs the unsharded
    pipeline (one jnp path: same per-pixel ops in the same order)."""
    from aswstereomatch_tpu.parallel import dshard

    cfg = CFG_FULL.replace(asw_symmetric=False)
    left = jnp.asarray(pair96["left"])
    right = jnp.asarray(pair96["right"])
    ref = np.asarray(J(pipeline.match_pair, cfg=cfg)(left, right))

    m4 = mesh_lib.build_mesh(data=1, tile=4)
    out_y = np.asarray(
        J(tiling.match_pair_tiled, cfg=cfg, device_mesh=m4)(left, right)
    )
    np.testing.assert_array_equal(out_y, ref)

    out_d = np.asarray(
        J(dshard.match_pair_dsharded, cfg=cfg, device_mesh=m4)(left, right)
    )
    np.testing.assert_array_equal(out_d, ref)

    m2 = mesh_lib.build_mesh(data=1, tile=2)  # 64 cols / 2 fits the D halo
    out_x = np.asarray(
        J(tiling.match_pair_tiled_x, cfg=cfg, device_mesh=m2)(left, right)
    )
    np.testing.assert_array_equal(out_x, ref)

    # Batched DP x SP: the per-shard batch is vmapped and must still match
    # the unsharded pipeline exactly.
    m22 = mesh_lib.build_mesh(data=2, tile=2)
    lefts = jnp.stack([left, left])
    rights = jnp.stack([right, right])
    slefts, srights = tiling.shard_batch_arrays((lefts, rights), m22)
    out_b = np.asarray(
        J(tiling.match_batch_sharded, cfg=cfg, device_mesh=m22)(
            slefts, srights
        )
    )
    np.testing.assert_array_equal(out_b[0], ref)
    np.testing.assert_array_equal(out_b[1], ref)


def test_separable_tiled_xtiled_dsharded_exact(pair96):
    """The separable speed mode inherits all three sharded layouts through
    aggregate_asw_from_stacks — tiled == untiled stays bit-exact."""
    from aswstereomatch_tpu.parallel import dshard

    cfg = CFG_FULL.replace(asw_separable=True)
    left = jnp.asarray(pair96["left"])
    right = jnp.asarray(pair96["right"])
    ref = np.asarray(J(pipeline.match_pair, cfg=cfg)(left, right))
    m4 = mesh_lib.build_mesh(data=1, tile=4)
    m2 = mesh_lib.build_mesh(data=1, tile=2)  # x: D_max halo needs wide shards
    for fn, m in ((tiling.match_pair_tiled, m4),
                  (tiling.match_pair_tiled_x, m2),
                  (dshard.match_pair_dsharded, m4)):
        out = np.asarray(J(fn, cfg=cfg, device_mesh=m)(left, right))
        np.testing.assert_array_equal(out, ref, err_msg=fn.__name__)
