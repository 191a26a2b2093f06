"""Separable two-pass ASW vs its own NumPy loop spec
(``oracle_numpy.aggregate_asw_separable``), over the geometry matrix the
separable kernel was once tested on: both weight modes, both costs, odd
shapes, D=16 with r=3, D=128, and the K=33 production and K=65 windows.
Shapes are cut where the loop oracle could not otherwise afford them.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from aswstereomatch_tpu.config import StereoConfig
from aswstereomatch_tpu.models import oracle_numpy as oracle
from aswstereomatch_tpu.models import pipeline
from aswstereomatch_tpu.ops import aggregate, preprocess

from test_jnp_vs_oracle_exact import (
    FULL, J, _pair, check_pipeline_vs_oracle, check_volume_vs_oracle,
)

SEP = StereoConfig(
    max_disparity=8, cost="tad_grad", aggregation="asw", window_radius=2,
    asw_symmetric=False, asw_separable=True, gamma_color=14.0,
    gamma_spatial=9.0,
)
SYM = SEP.replace(asw_symmetric=True)


@pytest.mark.parametrize(
    "cfg,shape",
    [
        (SYM, (24, 40)),
        (SEP, (24, 40)),  # left-only
        (SYM.replace(cost="ad"), (24, 40)),
        (SYM, (21, 150)),  # odd H and W
        (SYM.replace(max_disparity=16, window_radius=3), (20, 100)),
        (SYM.replace(max_disparity=128), (3, 140)),
        # the production K=33 window and a K=65 window
        (SYM.replace(max_disparity=16, window_radius=16), (6, 48)),
        (SYM.replace(max_disparity=8, window_radius=32), (4, 40)),
    ],
    ids=["sym", "leftonly", "ad_cost", "multitile_odd", "d16_r3",
         "d128_multinb", "k33_flagship", "k65_boundary"],
)
def test_separable_volume_matches_oracle(cfg, shape):
    check_volume_vs_oracle(cfg, _pair(*shape, cfg.max_disparity, seed=3))


@pytest.mark.parametrize(
    "cfg,shape",
    [
        (SEP, (24, 40)),
        (SEP.replace(max_disparity=16, window_radius=16), (6, 48)),
    ],
    ids=["leftonly_small", "leftonly_k33"],
)
def test_separable_leftonly_matches_oracle(cfg, shape):
    check_volume_vs_oracle(cfg, _pair(*shape, cfg.max_disparity, seed=3))


@pytest.mark.parametrize("sym", [True, False], ids=["sym", "leftonly"])
def test_separable_pipeline_end_to_end_matches_oracle(sym):
    cfg = SEP.replace(asw_symmetric=sym, max_disparity=16, window_radius=3,
                      **FULL)
    check_pipeline_vs_oracle(cfg, _pair(24, 60, 16, seed=11))


def test_separable_chunked_equals_unchunked_exactly():
    # H divisible by y_chunks: with bottom padding (H=37) one pixel differs
    # by 1 f32 ulp, on the parent commit too — an open item, not pinned here
    cfg = SYM.replace(max_disparity=16, window_radius=3, **FULL)
    pair = _pair(40, 101, 16, seed=11)
    l, r = jnp.asarray(pair["left"]), jnp.asarray(pair["right"])
    ref = np.asarray(J(pipeline.match_pair, cfg=cfg)(l, r))
    out = np.asarray(J(pipeline.match_pair, cfg=cfg.replace(y_chunks=4))(l, r))
    np.testing.assert_array_equal(out, ref)


def test_separable_batch_matches_single():
    cfg = SYM.replace(**FULL)
    pair = _pair(24, 48, 8, seed=5)
    l, r = jnp.asarray(pair["left"]), jnp.asarray(pair["right"])
    single = np.asarray(J(pipeline.match_pair, cfg=cfg)(l, r))
    batch = np.asarray(J(pipeline.match_batch, cfg=cfg)(
        jnp.stack([l, l]), jnp.stack([r, r])))
    np.testing.assert_allclose(batch[0], single, atol=1e-4)
    np.testing.assert_array_equal(batch[0], batch[1])


def test_separable_uniqueness_gate_matches_oracle():
    """The uniqueness gate on a separable volume: identical reject mask."""
    cfg = SYM.replace(max_disparity=16, window_radius=3, lr_check=True,
                      subpixel=True, fill_holes=False, uniqueness_ratio=10.0)
    pair = _pair(20, 48, 16, seed=3)
    l, r = jnp.asarray(pair["left"]), jnp.asarray(pair["right"])
    d = np.asarray(J(pipeline.match_pair, cfg=cfg)(l, r))
    d_o = oracle.match_pair(pair["left"], pair["right"], cfg)
    assert 0.3 < float(np.mean(d >= 0)) < 1.0  # the gate fires
    np.testing.assert_array_equal(d >= 0, d_o >= 0)
    np.testing.assert_allclose(d, d_o, atol=1e-4)


def test_stacks_entry_routes_separable():
    """The sharded layouts call ``aggregate_asw_from_stacks`` directly; a
    separable config there must compute the separable window, never the
    exact O(K^2) one."""
    pair = _pair(16, 32, 8, seed=1)
    r_ = SYM.window_radius
    D = SYM.max_disparity
    ls = preprocess.channel_stack(jnp.asarray(pair["left"]))
    rs = preprocess.channel_stack(jnp.asarray(pair["right"]))
    ls = jnp.pad(ls, ((0, 0), (0, 0), (r_, r_)), mode="edge")
    rs = jnp.pad(rs, ((0, 0), (0, 0), (r_ + D - 1, r_)), mode="edge")
    via_stacks = np.asarray(J(aggregate.aggregate_asw_from_stacks,
                              cfg=SYM)(ls, rs))
    sep = np.asarray(J(aggregate.aggregate_asw_separable_from_stacks,
                       cfg=SYM)(ls, rs))
    exact = np.asarray(J(aggregate.aggregate_asw_from_stacks,
                         cfg=SYM.replace(asw_separable=False))(ls, rs))
    np.testing.assert_array_equal(via_stacks, sep)
    assert not np.allclose(via_stacks, exact)
