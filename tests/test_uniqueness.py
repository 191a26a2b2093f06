"""WTA-uniqueness confidence gate (config ``uniqueness_ratio``).

Refuse-mode as a tunable operating curve.  The
gate is the knob cv2.StereoBM/SGBM ship (``uniquenessRatio``): a pixel is
rejected unless its best aggregated cost wins the second-best over d
outside [best-1, best+1] by the configured percentage.  Pinned here:

  - the 5-loop NumPy oracle and the jnp volume path agree on the reject
    mask exactly;
  - the gate composes with lr_check (AND) and with fill_holes;
  - y-tiled / x-tiled / chunked runs stay bit-exact vs untiled;
  - disparity sharding rejects the knob (per-shard slabs cannot form the
    global second-best);
  - ratio=0 (default) is exactly the old behavior.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from aswstereomatch_tpu.config import StereoConfig
from aswstereomatch_tpu.models import oracle_numpy, pipeline
from aswstereomatch_tpu.parallel import dshard, mesh as mesh_lib, tiling
from aswstereomatch_tpu.utils import synthetic


def J(fn, **static):
    return jax.jit(functools.partial(fn, **static))


def _cfg(**kw):
    base = dict(
        max_disparity=16, cost="tad_grad", aggregation="asw",
        window_radius=3, lr_check=True, fill_holes=False, subpixel=True,
        median_filter=False, uniqueness_ratio=10.0,
    )
    base.update(kw)
    return StereoConfig(**base)


@pytest.fixture(scope="module")
def pair():
    return synthetic.make_pair(height=40, width=72, max_disparity=16, seed=3)


@pytest.mark.parametrize(
    "sym,sep", [(True, False), (False, False), (True, True), (False, True)],
    ids=["sym", "leftonly", "sep_sym", "sep_leftonly"],
)
def test_gate_parity_oracle_jnp(pair, sym, sep):
    cfg = _cfg(asw_symmetric=sym, asw_separable=sep)
    l, r = jnp.asarray(pair["left"]), jnp.asarray(pair["right"])
    jn = np.asarray(J(pipeline.match_pair, cfg=cfg)(l, r))
    orc = oracle_numpy.match_pair(pair["left"], pair["right"], cfg)
    # the gate must actually fire on this scene
    cov = float(np.mean(jn >= 0))
    assert 0.5 < cov < 1.0, cov
    # reject masks identical; values agree to f32 tolerance
    np.testing.assert_array_equal(jn >= 0, orc >= 0)
    np.testing.assert_allclose(jn, orc, atol=1e-4)


def test_gate_without_lr_check(pair):
    """uniqueness alone gates (lr_check off) and obeys fill_holes."""
    cfg = _cfg(lr_check=False)
    l, r = jnp.asarray(pair["left"]), jnp.asarray(pair["right"])
    holes = np.asarray(J(pipeline.match_pair, cfg=cfg)(l, r))
    assert 0.5 < float(np.mean(holes >= 0)) < 1.0
    filled = np.asarray(
        J(pipeline.match_pair, cfg=cfg.replace(fill_holes=True))(l, r)
    )
    assert float(np.mean(filled >= 0)) == 1.0
    orc = oracle_numpy.match_pair(pair["left"], pair["right"], cfg)
    np.testing.assert_array_equal(holes >= 0, orc >= 0)


def test_coverage_monotone_in_ratio(pair):
    """Higher ratio -> stricter gate -> (weakly) lower coverage: the
    operating curve is actually tunable."""
    l, r = jnp.asarray(pair["left"]), jnp.asarray(pair["right"])
    covs = []
    for ratio in (0.0, 5.0, 15.0, 40.0):
        out = np.asarray(
            J(pipeline.match_pair, cfg=_cfg(uniqueness_ratio=ratio))(l, r)
        )
        covs.append(float(np.mean(out >= 0)))
    assert all(a >= b for a, b in zip(covs, covs[1:])), covs
    assert covs[-1] < covs[0]  # the sweep spans a real range


def test_ratio_zero_is_default_behavior(pair):
    l, r = jnp.asarray(pair["left"]), jnp.asarray(pair["right"])
    a = np.asarray(J(pipeline.match_pair, cfg=_cfg(uniqueness_ratio=0.0))(l, r))
    b = np.asarray(
        J(pipeline.match_pair, cfg=_cfg().replace(uniqueness_ratio=0.0))(l, r)
    )
    np.testing.assert_array_equal(a, b)
    dense = np.asarray(
        J(pipeline.match_pair,
          cfg=_cfg(uniqueness_ratio=0.0, fill_holes=True))(l, r)
    )
    assert float(np.mean(dense >= 0)) == 1.0


def test_tiled_layouts_bit_exact_with_gate():
    pair = synthetic.make_pair(height=96, width=64, max_disparity=16, seed=13)
    l, r = jnp.asarray(pair["left"]), jnp.asarray(pair["right"])
    cfg = _cfg(window_radius=4, fill_holes=True, median_filter=True,
               uniqueness_ratio=15.0)
    ref = np.asarray(J(pipeline.match_pair, cfg=cfg)(l, r))
    m4 = mesh_lib.build_mesh(data=1, tile=4)
    m2 = mesh_lib.build_mesh(data=1, tile=2)
    out_y = np.asarray(J(tiling.match_pair_tiled, cfg=cfg, device_mesh=m4)(l, r))
    np.testing.assert_array_equal(out_y, ref)
    out_x = np.asarray(
        J(tiling.match_pair_tiled_x, cfg=cfg, device_mesh=m2)(l, r)
    )
    np.testing.assert_array_equal(out_x, ref)
    out_c = np.asarray(J(pipeline.match_pair, cfg=cfg.replace(y_chunks=3))(l, r))
    np.testing.assert_array_equal(out_c, ref)


def test_dshard_rejects_uniqueness():
    pair = synthetic.make_pair(height=40, width=64, max_disparity=16, seed=1)
    m = mesh_lib.build_mesh(data=1, tile=4)
    with pytest.raises(ValueError, match="uniqueness"):
        dshard.match_pair_dsharded(
            jnp.asarray(pair["left"]), jnp.asarray(pair["right"]),
            _cfg(window_radius=4), m,
        )


def test_config_validation():
    with pytest.raises(ValueError, match="uniqueness_ratio"):
        StereoConfig(uniqueness_ratio=-1.0)


def test_confidence_surface_reproduces_gate(pair):
    """match_pair_with_confidence: thresholding the exported uniq_pct
    host-side reproduces the in-graph uniqueness_ratio gate's reject mask
    (up to f32 division rounding — assert exact here on a scene with no
    knife-edge ties), and lr_valid matches the LR gate."""
    l, r = jnp.asarray(pair["left"]), jnp.asarray(pair["right"])
    base = _cfg(uniqueness_ratio=0.0)  # gates off in the confidence run
    disp, uniq, lrv = jax.jit(
        functools.partial(pipeline.match_pair_with_confidence, cfg=base)
    )(l, r)
    disp, uniq, lrv = map(np.asarray, (disp, uniq, lrv))
    # disp from the confidence run carries the configured gates (LR only)
    np.testing.assert_array_equal(
        disp, np.asarray(J(pipeline.match_pair, cfg=base)(l, r))
    )
    for ratio in (5.0, 15.0):
        gated = np.asarray(
            J(pipeline.match_pair, cfg=_cfg(uniqueness_ratio=ratio))(l, r)
        )
        host_mask = lrv & (uniq >= ratio)
        np.testing.assert_array_equal(host_mask, gated >= 0)


def test_confidence_zero_cost_pixels_accept():
    """Exact-zero best cost: the canonical gate accepts at every ratio
    (second*100 >= 0 always), so the exported margin must be the +inf
    sentinel there, not a clipped 0 (review round-5 finding)."""
    # identical constant images -> AD cost exactly 0 at every (x, d)
    flat = np.full((16, 48, 3), 128.0, np.float32)
    cfg = _cfg(cost="ad", lr_check=False, uniqueness_ratio=0.0,
               aggregation="box", window_radius=2, max_disparity=8)
    disp, uniq, lrv = jax.jit(
        functools.partial(pipeline.match_pair_with_confidence, cfg=cfg)
    )(jnp.asarray(flat), jnp.asarray(flat))
    uniq = np.asarray(uniq)
    assert float(uniq.min()) >= 1e6 - 1
    # and the in-graph gate agrees: everything accepted at a high ratio
    gated = np.asarray(J(
        pipeline.match_pair,
        cfg=cfg.replace(uniqueness_ratio=50.0, fill_holes=False),
    )(jnp.asarray(flat), jnp.asarray(flat)))
    assert float(np.mean(gated >= 0)) == 1.0


def test_confidence_rejects_y_chunks():
    with pytest.raises(ValueError, match="y_chunks"):
        pipeline.match_pair_with_confidence(
            jnp.zeros((32, 48, 3)), jnp.zeros((32, 48, 3)),
            _cfg(y_chunks=2),
        )
