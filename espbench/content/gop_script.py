"""Content generation helpers: realistic-density streams for benchmarks.

A frozen copy of espflix_tpu_torch/tools/content.py, kept with
the benchmark so that the yardstick does not move when the program
changes.

The reference's service encodes 352x192 @ ~1.5 Mb/s with no B frames
(indexer/indexer.cpp:307).  These helpers produce random
scripts whose symbol/byte density matches that operating point so
benchmark numbers reflect production decode load.
"""

from __future__ import annotations

import numpy as np

from espbench.content import mpeg1_encode as E


def realistic_gop_script(rng, width=352, height=192, n_pictures=12,
                         i_coeffs=6, p_coeffs=8):
    """GOP-structured script (I + P...) tuned near 1.5 Mb/s @ 30 fps."""
    mb_w, mb_h = (width + 15) >> 4, (height + 15) >> 4
    script = {"width": width, "height": height, "pictures": []}
    for k in range(n_pictures):
        is_i = k % n_pictures == 0
        pic = {"type": "I" if is_i else "P", "full_pel": 0,
               "f_code": 3, "slices": []}
        for row in range(mb_h):
            sl = {"row": row, "qscale": 8, "mbs": []}
            for x in range(mb_w):
                if is_i:
                    mb = {"addr_inc": 1, "intra": True, "blocks": [
                        E._rand_block(rng, True, i_coeffs)
                        for _ in range(6)]}
                else:
                    coded = rng.random() < 0.55
                    has_mv = rng.random() < 0.5
                    mv = None
                    if has_mv:
                        hlo, hhi = E._safe_mv_range(x, 16, width, 0, 3)
                        vlo, vhi = E._safe_mv_range(row, 16, height, 0, 3)
                        mv = (int(rng.integers(max(hlo, -64),
                                               min(hhi, 64) + 1)),
                              int(rng.integers(max(vlo, -32),
                                               min(vhi, 32) + 1)))
                    blocks = [None] * 6
                    if coded:
                        nb = int(rng.integers(1, 4))
                        for i in rng.choice(6, size=nb, replace=False):
                            blocks[int(i)] = E._rand_block(
                                rng, False, p_coeffs)
                    if mv is None and not coded:
                        if rng.random() < 0.5 and x > 0:
                            mv = (0, 0)  # MC-not-coded
                        else:
                            blocks[0] = E._rand_block(rng, False, 1)
                    mb = {"addr_inc": 1, "intra": False, "mv": mv,
                          "blocks": blocks}
                sl["mbs"].append(mb)
            pic["slices"].append(sl)
        script["pictures"].append(pic)
    return script


def realistic_es(seed=0, **kw) -> bytes:
    rng = np.random.default_rng(seed)
    return E.encode_es(realistic_gop_script(rng, **kw))
