"""One case generator for the composite field pair: K4
(composite.synthesize_field_pair_parts), its plain form and the JAX
package's composite_pallas.synthesize_field_pair_parts.

composite_case(seed, n_lanes) draws, from a numpy seed, the inputs of
one call, covering the edges of the kernel's arithmetic:

  * lane n takes blend class BLENDS[n % 7] (always on, hidden, the fade
    at 1, 16 and 31 of 32, full, past full), progress PROGRESS[n % 5]
    (empty, one unit, the bar's last unit, full, past the bar) and
    parity n % 2;
  * luma: a third of the pixels at 0..4 or 251..255, where y + dither
    crosses the 0xFC mask (255 + 3 wraps to 0), the rest uniform;
  * chroma (u and v): every value 0..255 in chroma rows 0 and 1 of
    every lane (canvas rows 0 and 2 take them as they are, row 1 their
    averages); a third of the other samples
    at 0, 127, 128, 129 or 255, the rest uniform, row 95 (the clamp of
    the odd-row average at the last row) drawn like the others;
  * the OSD text bytes uniform.

LANE_COUNTS are the tests' lane counts: 7 is not a multiple of K4's
eight lanes a block.  tests/test_torch_composite_edges.py draws its
cases here and chip_smoke.py its edge case on the card.
"""

import numpy as np

BLENDS = (-1, 0, 1, 16, 31, 32, 200)
PROGRESS = (0, 1, 239, 240, 352)
LUMA_EDGES = (0, 1, 2, 3, 4, 251, 252, 253, 254, 255)
CHROMA_EDGES = (0, 127, 128, 129, 255)
LANE_COUNTS = (7,)
# the case's arrays in the order synthesize_field_pair_parts takes them
ARGS = ("y", "u", "v", "parity", "osd", "blend", "progress")


def _mixed(rng, shape, edges):
    """uint8[shape]: a third of the values from `edges`, the rest
    uniform (uint8 draws: 1,024 lanes of luma are 69 M values)."""
    u8 = dict(dtype=np.uint8)
    pick = rng.integers(0, 3, shape, **u8) == 0
    edge = np.asarray(edges, np.uint8)[rng.integers(0, len(edges), shape,
                                                    **u8)]
    return np.where(pick, edge, rng.integers(0, 256, shape, **u8))


def composite_case(seed: int, n_lanes: int = 7) -> dict:
    """The inputs of one K4 call as numpy arrays (see the module
    docstring): y uint8[N, 192, 352], u, v uint8[N, 96, 176], parity,
    blend, progress int32[N], osd uint8[N, 16, 80]."""
    rng = np.random.default_rng(seed)
    N = n_lanes
    lanes = np.arange(N)
    y = _mixed(rng, (N, 192, 352), LUMA_EDGES)
    chroma = {}
    for key in "uv":
        c = _mixed(rng, (N, 96, 176), CHROMA_EDGES)
        # rows 0 and 1 hold a random permutation of 0..255 (and 96 more
        # values) a lane: row 0 alone, and its average with row 1
        c[:, :2] = np.stack([rng.permutation(352) % 256
                             for _ in range(N)]).reshape(N, 2, 176)
        chroma[key] = c
    return dict(
        y=y, u=chroma["u"], v=chroma["v"],
        parity=(lanes % 2).astype(np.int32),
        osd=rng.integers(0, 256, (N, 16, 80), dtype=np.uint8),
        blend=np.asarray([BLENDS[n % len(BLENDS)] for n in lanes],
                         np.int32),
        progress=np.asarray([PROGRESS[n % len(PROGRESS)] for n in lanes],
                            np.int32))

