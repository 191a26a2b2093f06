"""Public API surface: presets, validation, matcher ergonomics."""

import numpy as np
import jax.numpy as jnp
import pytest

import aswstereomatch_tpu as asm


def test_all_presets_construct_matchers():
    for name in sorted(asm.PRESETS):
        m = asm.StereoMatcher.from_preset(name)
        assert m.cfg.max_disparity >= 16


def test_matcher_validates_inputs():
    m = asm.StereoMatcher(asm.StereoConfig(max_disparity=8, aggregation="box",
                                           window_radius=2))
    left = np.zeros((16, 24, 3), np.float32)
    with pytest.raises(ValueError, match="mismatch"):
        m(left, np.zeros((12, 24, 3), np.float32))
    with pytest.raises(ValueError, match="expected"):
        m(np.zeros((16,), np.float32), np.zeros((16,), np.float32))
    with pytest.raises(ValueError, match="expected"):
        m.batch(left[..., 0], left[..., 0])  # 2D arrays passed to batch


def test_preset_overrides():
    m = asm.StereoMatcher.from_preset("tsukuba_ad_box", max_disparity=8)
    assert m.cfg.max_disparity == 8
    out = m(np.zeros((16, 24, 3), np.float32), np.zeros((16, 24, 3), np.float32))
    assert out.shape == (16, 24)


def test_config_hash_stable_and_distinct():
    a = asm.StereoConfig()
    b = asm.StereoConfig(max_disparity=32)
    assert a.config_hash() == asm.StereoConfig().config_hash()
    assert a.config_hash() != b.config_hash()


def test_uint8_inputs_match_float32_exactly():
    """The serving/sweep/cli uint8 transfer path: the matcher accepts uint8
    inputs (widened to f32 on device inside the compiled program) and must
    produce bit-identical disparities to the f32 call for integral
    [0, 255] images."""
    from aswstereomatch_tpu.utils import synthetic

    pair = synthetic.make_pair(height=32, width=48, max_disparity=8, seed=0)
    cfg = asm.StereoConfig(max_disparity=8, cost="tad_grad",
                           aggregation="asw", window_radius=3)
    m = asm.StereoMatcher(cfg)
    d_f = np.asarray(m(pair["left"], pair["right"]))
    d_8 = np.asarray(
        m(pair["left"].astype(np.uint8), pair["right"].astype(np.uint8))
    )
    np.testing.assert_array_equal(d_8, d_f)


def test_matcher_entry_points_are_plain_jit():
    """StereoMatcher's entry points are plain ``jax.jit`` programs: the
    call, batch and confidence entries agree with a jit of the pipeline
    function, and the exposed jitted entries lower and compile ahead of
    time (the serving daemon's warm-up path) to the same result."""
    import jax

    from aswstereomatch_tpu.models import pipeline
    from aswstereomatch_tpu.utils import synthetic

    pair = synthetic.make_pair(height=24, width=40, max_disparity=8, seed=3)
    cfg = asm.StereoConfig(max_disparity=8, aggregation="asw",
                           window_radius=2)
    m = asm.StereoMatcher(cfg)
    l, r = jnp.asarray(pair["left"]), jnp.asarray(pair["right"])
    d = np.asarray(m(l, r))
    ref = jax.jit(lambda a, b: pipeline.match_pair(a, b, cfg))(l, r)
    np.testing.assert_array_equal(d, np.asarray(ref))
    compiled = m.jit_pair.lower(l, r).compile()
    np.testing.assert_array_equal(np.asarray(compiled(l, r)), d)
    # batch entry point: each row is the single-pair result
    b = np.asarray(m.batch(jnp.stack([l, l]), jnp.stack([r, r])))
    np.testing.assert_allclose(b[0], d, atol=1e-4)
    np.testing.assert_array_equal(b[0], b[1])
    # confidence entry: disparity identical to the plain call
    dc, uniq, lrv = m.with_confidence(l, r)
    np.testing.assert_array_equal(np.asarray(dc), d)
    assert uniq.shape == lrv.shape == d.shape
    assert isinstance(m.jit_batch, type(jax.jit(lambda x: x)))


def test_matcher_cache_keys_both_dtypes():
    """Mixed-dtype calls (u8 left, f32 right) must compile their own
    program and agree with the all-f32 call on integral images."""
    from aswstereomatch_tpu.utils import synthetic

    pair = synthetic.make_pair(height=24, width=40, max_disparity=8, seed=4)
    cfg = asm.StereoConfig(max_disparity=8, aggregation="box",
                           window_radius=2, lr_check=False, fill_holes=False,
                           subpixel=False, median_filter=False, cost="ad")
    m = asm.StereoMatcher(cfg)
    l8 = pair["left"].astype(np.uint8)
    rf = pair["right"].astype(np.float32)
    d_mixed = np.asarray(m(l8, rf))
    d_f32 = np.asarray(m(pair["left"], pair["right"]))
    np.testing.assert_array_equal(d_mixed, d_f32)  # integral images: lossless
