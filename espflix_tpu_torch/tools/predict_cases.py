"""One case generator for K3P (mocomp.predict_plane / predict_chroma_pair /
predict_plane_rows), its plain forms and the JAX package's
predict_plane_mxu (rule A) and mocomp.predict_plane_rows (rule B).

predict_case(seed, mb_size, mb_width, mb_height, n_lanes) draws, from a
numpy seed, a reference plane uint8[N, H, W] and half-pel vectors
int32[N, mbh, mbw] at the plane's scale (S = mb_size, 16 or 8):

  * a quarter of the MBs with vectors uniform past every edge;
  * half with the window origin at and one past each edge -- -1, 0, 1,
    and W - S - 1, W - S, W - S + 1 (H along y) -- and a random
    half-pel phase on each axis, so that under rule B some windows'
    taps cross each of the four edges and some stop just inside;
  * a quarter with small vectors (every half-pel phase inside).

bands(mb_height) lists the bands (row0, rows) the rule-B callers
predict: the first MB row, one in the middle, the last MB row and the
whole plane.  The default n_lanes, 7, is not a multiple of 4.
tests/test_torch_predict_edges.py draws its cases here and
chip_smoke.py its K3P edge case on the card.
"""

import numpy as np

# (mb_width, mb_height) of the tests' cases: one MB column, a small
# plane, the bench's 352x192
SHAPES = ((1, 3), (5, 4), (22, 12))


def edge_vectors(rng, shape, mb_axis, size: int, S: int):
    """Half-pel vectors int32[shape] along one axis of a plane `size`
    pixels long, for MBs at index mb_axis (see the module docstring)."""
    base = np.broadcast_to(mb_axis * 2 * S, shape)
    uniform = rng.integers(-2 * size - 4 * S, 2 * size + 4 * S + 1, shape)
    origin = rng.choice([-1, 0, 1, size - S - 1, size - S, size - S + 1],
                        shape)
    at_edge = 2 * origin + rng.integers(0, 2, shape) - base
    small = rng.integers(-3, 4, shape)
    pick = rng.choice(3, shape, p=[0.25, 0.5, 0.25])
    return np.choose(pick, [uniform, at_edge, small]).astype(np.int32)


def predict_case(seed: int, mb_size: int, mb_width: int, mb_height: int,
                 n_lanes: int = 7) -> dict:
    """A K3P case as numpy arrays: ref uint8[N, H, W], mv_h / mv_v
    int32[N, mbh, mbw], mb_size, mb_width, mb_height."""
    rng = np.random.default_rng(seed)
    S, N = mb_size, n_lanes
    H, W = mb_height * S, mb_width * S
    shape = (N, mb_height, mb_width)
    return dict(
        mb_size=S, mb_width=mb_width, mb_height=mb_height,
        ref=rng.integers(0, 256, (N, H, W), dtype=np.uint8),
        mv_h=edge_vectors(rng, shape, np.arange(mb_width)[None, None, :],
                          W, S),
        mv_v=edge_vectors(rng, shape, np.arange(mb_height)[None, :, None],
                          H, S))


def bands(mb_height: int) -> list:
    """(row0, rows) of the bands a case is predicted in under rule B."""
    return sorted({(0, 1), (mb_height // 2, 1), (mb_height - 1, 1),
                   (0, mb_height)})


def crossings(c: dict) -> dict:
    """Masks bool[N, mbh, mbw] of the MBs whose rule-B taps cross each
    edge of the plane ("left", "right", "top", "bottom"; "edge": any of
    them, the MBs K3P predicts byte by byte) and of their half-pel
    phases ("hx", "hy"); c holds mv_h, mv_v, mb_size, mb_width and
    mb_height."""
    S, mbw, mbh = c["mb_size"], c["mb_width"], c["mb_height"]
    W, H = mbw * S, mbh * S
    xh = np.arange(mbw)[None, None, :] * 2 * S + c["mv_h"]
    yh = np.arange(mbh)[None, :, None] * 2 * S + c["mv_v"]
    x0, y0, hx, hy = xh >> 1, yh >> 1, xh & 1, yh & 1
    out = {"left": x0 < 0, "right": x0 + S - 1 + hx > W - 1,
           "top": y0 < 0, "bottom": y0 + S - 1 + hy > H - 1}
    out["edge"] = out["left"] | out["right"] | out["top"] | out["bottom"]
    out["hx"], out["hy"] = hx == 1, hy == 1
    return out


def edge_crossings(c: dict) -> dict:
    """How many MBs' rule-B taps cross each edge of the plane, and how
    many stay inside, by half-pel phase: {edge: count}."""
    m = crossings(c)
    counts = {k: int(m[k].sum()) for k in ("left", "right", "top",
                                           "bottom")}
    for px in (0, 1):
        for py in (0, 1):
            counts[f"inside_{px}{py}"] = int(
                (~m["edge"] & (m["hx"] == px) & (m["hy"] == py)).sum())
    return counts
