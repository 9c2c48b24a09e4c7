"""
Depth visualization on the host (a copy of the JAX package's utils/viz.py
without its LUT and name-dispatch helpers): inverse depth -> plasma
colormap, metric depth -> the reference's red-to-blue map (reference:
utils/depth.py:66-100, visualization/colormaps.py). numpy only, no
matplotlib.
"""

import numpy as np

# 16-stop plasma approximation (matplotlib plasma sampled)
_PLASMA = np.array([
    [0.050, 0.030, 0.528], [0.204, 0.017, 0.593], [0.312, 0.008, 0.636],
    [0.418, 0.001, 0.658], [0.516, 0.038, 0.648], [0.604, 0.110, 0.608],
    [0.682, 0.189, 0.548], [0.748, 0.266, 0.487], [0.807, 0.342, 0.428],
    [0.858, 0.423, 0.371], [0.903, 0.505, 0.313], [0.940, 0.592, 0.255],
    [0.967, 0.684, 0.195], [0.982, 0.781, 0.141], [0.980, 0.883, 0.125],
    [0.940, 0.975, 0.131]], np.float32)


def apply_colormap(x):
    """x in [0,1] [H,W] -> [H,W,3] plasma colors."""
    x = np.clip(x, 0.0, 1.0) * (len(_PLASMA) - 1)
    lo = np.floor(x).astype(int)
    hi = np.minimum(lo + 1, len(_PLASMA) - 1)
    w = (x - lo)[..., None]
    return _PLASMA[lo] * (1 - w) + _PLASMA[hi] * w


# Custom metric-depth colormap (red=near -> blue=far), the reference's
# shared viz colormap (reference: visualization/colormaps.py:36-141).
# Control points are (metric depth [m], RGB); rendering is piecewise-linear
# between them — numerically identical to matplotlib's
# LinearSegmentedColormap.from_list over the same (position, color) list,
# without the matplotlib dependency.
DEPTH_CMAP_POINTS = (
    (0.1, (1.0, 0.0, 0.0)), (0.3, (1.0, 0.0, 0.0)),
    (0.4, (1.0, 0.15, 0.0)), (0.5, (1.0, 0.35, 0.0)),
    (0.6, (1.0, 0.5, 0.0)), (0.8, (1.0, 0.55, 0.0)),
    (1.0, (1.0, 0.6, 0.0)), (1.1, (1.0, 0.7, 0.0)),
    (1.25, (1.0, 0.85, 0.0)), (1.4, (1.0, 1.0, 0.0)),
    (1.8, (1.0, 1.0, 0.0)), (2.2, (0.9, 1.0, 0.0)),
    (2.4, (0.7, 1.0, 0.1)), (2.5, (0.5, 1.0, 0.2)),
    (2.7, (0.3, 1.0, 0.3)), (3.0, (0.1, 1.0, 0.4)),
    (3.3, (0.0, 1.0, 0.5)), (3.5, (0.0, 1.0, 0.7)),
    (3.8, (0.0, 1.0, 0.85)), (4.5, (0.0, 1.0, 1.0)),
    (5.5, (0.0, 0.9, 1.0)), (6.5, (0.0, 0.7, 1.0)),
    (7.0, (0.0, 0.5, 1.0)), (8.0, (0.0, 0.3, 1.0)),
    (10.0, (0.0, 0.15, 1.0)), (12.0, (0.0, 0.05, 1.0)),
    (15.0, (0.0, 0.0, 1.0)),
)


def depth_cmap_stops(min_depth=0.1, max_depth=15.0, points=DEPTH_CMAP_POINTS):
    """(positions in [0,1], colors) after the reference's range clamping:
    control points outside [min_depth, max_depth] are dropped; missing
    boundary points are inserted with the nearest surviving color on each
    side (reference: visualization/colormaps.py:108-136)."""
    if max_depth <= min_depth:
        raise ValueError('max_depth must be > min_depth (got {}..{})'.format(
            min_depth, max_depth))
    pts = [(d, c) for d, c in points if min_depth <= d <= max_depth]
    if not pts or pts[0][0] > min_depth:
        col = next((c for d, c in points if d >= min_depth),
                   points[-1][1])
        pts.insert(0, (min_depth, col))
    if pts[-1][0] < max_depth:
        pts.append((max_depth, points[-1][1]))
    span = max_depth - min_depth
    pos = np.array([(d - min_depth) / span for d, _ in pts], np.float64)
    pos[0], pos[-1] = 0.0, 1.0
    return pos, np.array([c for _, c in pts], np.float32)


def viz_depth_metric(depth, min_depth=0.1, max_depth=15.0,
                     points=DEPTH_CMAP_POINTS):
    """Colormapped METRIC depth [H,W] -> [H,W,3]: red=near, blue=far
    (the reference viz scripts' shared colormap). Depths are clipped to
    [min_depth, max_depth]; invalid (<=0) pixels render black."""
    depth = np.asarray(depth, np.float32)
    if depth.ndim == 3:
        depth = depth[..., 0] if depth.shape[-1] == 1 else depth[0]
    pos, cols = depth_cmap_stops(min_depth, max_depth, points)
    x = (np.clip(depth, min_depth, max_depth) - min_depth) / (
        max_depth - min_depth)
    rgb = np.stack([np.interp(x, pos, cols[:, ch]) for ch in range(3)],
                   axis=-1).astype(np.float32)
    return np.where((depth > 0)[..., None], rgb, 0.0)


def viz_inv_depth(inv_depth, normalizer=None, percentile=95,
                  filter_zeros=False):
    """Colormapped inverse depth (reference: utils/depth.py:66-100)."""
    inv_depth = np.asarray(inv_depth)
    if inv_depth.ndim == 3:
        inv_depth = inv_depth[..., 0] if inv_depth.shape[-1] == 1 \
            else inv_depth[0]
    if normalizer is None:
        vals = inv_depth[inv_depth > 0] if filter_zeros else inv_depth
        normalizer = np.percentile(vals, percentile) if vals.size else 1.0
    return apply_colormap(inv_depth / (normalizer + 1e-6))
