"""Host-side chunk inputs shaped like bench.py --stage full.

``bench_chunk`` builds the per-tick xs of the full chain exactly as
bench.py's build_chain does (bench.py:268-343): realistic I/P GOPs at
352x192 (tools/content.realistic_gop_script), `distinct` streams tiled
over the lanes with a mixed GOP phase, span-sorted slice rows, 13 SBC
frames per tick from random_frame(mode=0, bitpool=28), and random OSD,
blend, progress, parity, beep and starved state.  The arrays are numpy,
so the same inputs feed the JAX package and the port.
"""

from __future__ import annotations

import numpy as np

from espflix_tpu_torch.tools import mpeg1_encode as E
from espflix_tpu_torch.tools.content import realistic_gop_script
from espflix_tpu_torch.tools.sbc_encode import random_frame
from espflix_tpu_torch.models import mpeg1 as M
from espflix_tpu_torch.models import sbc as dsbc
from espflix_tpu_torch.ops import scan_dense as SD
from espflix_tpu_torch.ops import vlc_scan as VS

F_AUDIO = 13        # 13 x 128 = 1664 >= 1600 PCM samples per 30 Hz tick


def bench_chunk(lanes: int, *, n_pictures: int = 12, distinct: int = 8,
                win: bool = False, starve_p: float = 0.01,
                long_rows: int | None = None):
    """(xs, kw): xs a dict of numpy [K, ...] arrays (K = n_pictures)
    with the decode keys (device-window keys when `win`) and the output
    keys; kw the static keyword arguments of run_full_chunk."""
    streams = []
    for s in range(distinct):
        rng = np.random.default_rng(1000 + s)
        streams.append(M.parse_es(E.encode_es(realistic_gop_script(
            rng, n_pictures=n_pictures)))[1])
    seq = streams[0][0].seq
    mbw, mbh = seq.mb_width, seq.mb_height
    wpl = max(max((len(p.payload) + 3) // 4 + 4 for p in ps)
              for ps in streams)
    phase = np.random.default_rng(7).integers(0, n_pictures, lanes)
    K = n_pictures
    sls, bats, perms = [], [], []
    for k in range(K):
        sel = [streams[i % distinct][(k + phase[i]) % n_pictures]
               for i in range(lanes)]
        b = M.make_picture_batch(sel, words_per_lane=wpl, max_slices=mbh)
        sl = VS.pack_slice_rows(b, sort_rows=True, device_windows=win)
        assert not sl["overflow"].any()
        perm, dup = SD.row_perm(sl["lane_of_row"], sl["rows"],
                                sl["alive"], lanes, mbh)
        assert not dup.any()
        sls.append(sl)
        bats.append(b)
        perms.append(perm)
    wkey = "lane_words" if win else "words"
    width = max(sl[wkey].shape[1] for sl in sls)
    for sl in sls:
        sl[wkey] = np.pad(sl[wkey], ((0, 0), (0, width - sl[wkey].shape[1])))
    keys = ((wkey, "row_base") if win else (wkey,)) + (
        "start_bits", "rows", "alive", "pic_type", "full_pel", "r_size",
        "lane_of_row")
    xs = {k: np.stack([sl[k] for sl in sls]) for k in keys}
    xs["perm"] = np.stack(perms)
    for k in ("intra_q", "non_intra_q", "active"):
        xs[k] = np.stack([b[k] for b in bats])

    arng = np.random.default_rng(17)
    frames_a = np.stack(
        [np.frombuffer(random_frame(arng, mode=0, bitpool=28), np.uint8)
         for _ in range(F_AUDIO)])
    aw = dsbc.frames_to_words(np.ascontiguousarray(
        np.broadcast_to(frames_a, (lanes, F_AUDIO, 64))))
    orng = np.random.default_rng(23)
    xs.update(
        osd=orng.integers(0, 256, (K, lanes, 16, 80), dtype=np.uint8),
        blend=orng.integers(0, 256, (K, lanes)).astype(np.int32),
        progress=orng.integers(0, 352, (K, lanes)).astype(np.int32),
        parity=orng.integers(0, 2, (K, lanes)).astype(np.int32),
        beep_left=orng.integers(0, 3, (K, lanes)).astype(np.int32),
        aud_words=np.broadcast_to(aw, (K,) + aw.shape).copy(),
        aud_act=np.ones((K, lanes), bool),
        aud_nval=np.full((K, lanes), F_AUDIO, np.int32),
        starved=orng.random((K, lanes)) < starve_p,
    )
    NS = lanes * mbh
    kw = dict(mb_width=mbw, mb_height=mbh, n_lanes=lanes,
              long_rows=long_rows or min(2 * lanes, NS // 2),
              steps_long=1024, steps_short=384, n_aud_frames=F_AUDIO,
              channels=1, pal=False, scrolled=False,
              win=max(sl["win"] for sl in sls) if win else 0, chunk=128)
    return xs, kw
