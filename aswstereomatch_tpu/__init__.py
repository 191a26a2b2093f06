"""aswstereomatch_tpu — a dense stereo-matching engine in JAX.

Built from scratch in JAX/XLA with the full capabilities of the
C++/OpenCV reference ZhangYY12345/aswStereoMatch (see SURVEY.md): AD and
TAD+gradient cost volumes, Yoon-Kweon adaptive-support-weight aggregation,
winner-take-all with left-right consistency, hole filling, subpixel
refinement and median smoothing, compiled by XLA for the GPU; mesh sharding
with halo exchange for multi-device/multi-host scaling.
"""

from .config import PRESETS, StereoConfig, get_preset  # noqa: F401
from .models.pipeline import StereoMatcher, match_batch, match_pair  # noqa: F401

__version__ = "0.1.0"
