"""Left-only and symmetric exact ASW, and box at D=16, vs the NumPy loop
oracle over the geometry matrix the disparity-in-lanes kernels were once
tested on: multiple tiles with odd H and W, D=16 with r=3, and D=128.
Shapes are cut where the loop oracle could not otherwise afford them
(D=128 runs on two or three rows).

Each case compares the jnp path with ``models/oracle_numpy`` at the same
parameters (volumes to f32 tolerance, winners, right-view winners).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from aswstereomatch_tpu.config import StereoConfig
from aswstereomatch_tpu.models import pipeline

from test_jnp_vs_oracle_exact import (
    FULL, J, _pair, check_pipeline_vs_oracle, check_volume_vs_oracle,
)

CFG = StereoConfig(
    max_disparity=8, cost="tad_grad", aggregation="asw", window_radius=2,
    asw_symmetric=False, gamma_color=14.0, gamma_spatial=9.0,
)
SCFG = CFG.replace(asw_symmetric=True)


@pytest.mark.parametrize(
    "cfg,shape",
    [
        (CFG, (24, 40)),
        (CFG.replace(cost="ad"), (24, 40)),
        (CFG, (21, 150)),  # odd H and W
        (CFG.replace(max_disparity=16, window_radius=3), (12, 60)),
        (CFG.replace(max_disparity=128), (2, 136)),
    ],
    ids=["base", "ad_cost", "multitile_odd", "d16_r3", "d128_multinb"],
)
def test_leftonly_volume_matches_oracle(cfg, shape):
    check_volume_vs_oracle(cfg, _pair(*shape, cfg.max_disparity, seed=3))


def test_leftonly_pipeline_end_to_end_matches_oracle():
    check_pipeline_vs_oracle(CFG.replace(**FULL), _pair(24, 40, 8, seed=5))


@pytest.mark.parametrize("shape", [(24, 40), (21, 150)], ids=["one", "multi"])
def test_box_d16_volume_matches_oracle(shape):
    cfg = StereoConfig(max_disparity=16, cost="tad_grad", aggregation="box",
                       window_radius=3)
    check_volume_vs_oracle(cfg, _pair(*shape, 16, seed=3))


def test_config_validation():
    """Mode combinations the pipeline cannot run are refused up front."""
    with pytest.raises(ValueError, match="asw_separable"):
        CFG.replace(aggregation="box", asw_separable=True)
    with pytest.raises(ValueError, match="max_disparity"):
        CFG.replace(max_disparity=0)
    with pytest.raises(ValueError, match="window_radius"):
        CFG.replace(window_radius=-1)
    with pytest.raises(ValueError, match="median_mode"):
        CFG.replace(median_mode="bogus")
    with pytest.raises(TypeError):  # no backend selection: one jnp path
        StereoConfig(backend="jnp")


def test_leftonly_tiled_equals_untiled_exactly():
    from aswstereomatch_tpu.parallel import mesh as mesh_lib
    from aswstereomatch_tpu.parallel import tiling

    cfg = CFG.replace(window_radius=3, **FULL)
    pair = _pair(96, 128, 8, seed=7)
    l, r = jnp.asarray(pair["left"]), jnp.asarray(pair["right"])
    ref = np.asarray(J(pipeline.match_pair, cfg=cfg)(l, r))
    m = mesh_lib.build_mesh(data=1, tile=4)
    out = np.asarray(J(tiling.match_pair_tiled, cfg=cfg, device_mesh=m)(l, r))
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize(
    "cfg,shape",
    [
        (SCFG, (24, 40)),
        (SCFG, (21, 150)),  # odd H and W
        (SCFG.replace(max_disparity=16, window_radius=3), (12, 60)),
        (SCFG.replace(max_disparity=128, window_radius=1), (2, 136)),
    ],
    ids=["base", "multitile_odd", "d16_r3", "d128_multinb"],
)
def test_symmetric_volume_matches_oracle(cfg, shape):
    check_volume_vs_oracle(cfg, _pair(*shape, cfg.max_disparity, seed=3))


def test_symmetric_pipeline_end_to_end_matches_oracle():
    check_pipeline_vs_oracle(SCFG.replace(**FULL), _pair(24, 40, 8, seed=5))


def test_batch_matches_single_across_modes():
    """vmap batching reproduces single-pair results for left-only, box and
    symmetric configs."""
    pair = _pair(24, 48, 8, seed=5)
    l, r = jnp.asarray(pair["left"]), jnp.asarray(pair["right"])
    for cfg in (CFG.replace(**FULL), CFG.replace(aggregation="box"),
                SCFG.replace(**FULL)):
        single = np.asarray(J(pipeline.match_pair, cfg=cfg)(l, r))
        batch = np.asarray(J(pipeline.match_batch, cfg=cfg)(
            jnp.stack([l, l]), jnp.stack([r, r])))
        np.testing.assert_allclose(batch[0], single, atol=1e-4)
        np.testing.assert_array_equal(batch[0], batch[1])
